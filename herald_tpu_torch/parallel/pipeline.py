"""Pipeline parallelism over a pp group of ranks (port of
`herald_tpu/parallel/pipeline.py`): GPipe (`pipeline_apply`), PipeDream
1F1B with weight stashing (`pipedream_apply`) and HetPipe
(`hetpipe_apply`).

N stages live on the N ranks of a pp `Comm` (`parallel/comm.py`; its
rank is the stage); a batch is split into M micro-batches. JAX scans the
ticks inside one compiled program and moves activations with one
`lax.ppermute` a tick; here each tick is a Python step and the move is
`ppermute`, an autograd Function over `Comm.shift` (posted sends and
receives, so the ring cannot deadlock) whose backward is the inverse
shift. Every rank shifts on every tick or slot, whatever it computed.

- GPipe: at tick t stage s computes micro-batch t - s; the output is
  valid on the last stage only. Every rank runs the same ops on every
  tick, with masks as JAX's (`where(s == 0, feed, state)`), so every rank
  builds the same autograd graph and the backward's shifts run in one
  order on all of them; `torch.autograd` through the ticks is the
  all-forward-all-backward GPipe schedule, the micro-batches' weight
  gradients summed by autograd. Seed the loss on the last stage only
  (`stage_loss`).
- PipeDream 1F1B: JAX's closed-form timetable, forward of micro-batch m
  at stage s in slot F(s, m) = s + 2m and its backward in B(s, m) =
  2N - 1 - s + 2m, over 2(M + N - 1) slots, with an N-deep stash of the
  input and the weights each forward used; the backward recomputes the
  stage from the stash (`torch.autograd.grad`) and applies the update at
  once. A stage computes only in its own slots: what it sends in another
  slot is never read by its neighbour (the timetable's parities), so it
  sends zeros there, where JAX sends a masked value. Collectives inside
  `stage_fn` or `update_fn` must be over groups whose ranks share the
  stage (an mp or a dp group), which share its timetable.
- HetPipe: 1F1B per pipeline replica with local updates, each stage's
  params averaged over its dp group after every k-th update and once at
  the drain.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch


class _Shift(torch.autograd.Function):
    """x of the previous rank of the ring; backward: the next rank's
    gradient (the inverse shift, JAX's transpose of `ppermute`)."""

    @staticmethod
    def forward(ctx, x, comm, offset):
        ctx.comm, ctx.offset = comm, offset
        return comm.shift(x, offset)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.shift(g, -ctx.offset), None, None


def ppermute(x: torch.Tensor, comm, offset: int = 1) -> torch.Tensor:
    """Every rank's x moved `offset` ranks on round the ring (JAX's
    `lax.ppermute` with perm [(s, (s + offset) % N)])."""
    return _Shift.apply(x, comm, offset)


def stage_params(stacked_params: Dict[str, torch.Tensor],
                 comm) -> Dict[str, torch.Tensor]:
    """This stage's params out of a stacked dict whose leaves carry a
    leading [num_stages] dim (JAX receives its stage's slice through the
    sharding; here every rank holds the stack and takes its row)."""
    return {k: v[comm.rank] for k, v in stacked_params.items()}


def _flag(cond: bool, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(cond, device=like.device)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   my_params, x: torch.Tensor, comm, num_stages: int,
                   num_microbatches: int) -> torch.Tensor:
    """Run the rotating pipeline (GPipe). Every rank of the pp group gets
    the SAME x [B, d]; stage 0 feeds it in micro-batch by micro-batch.
    Returns [B, d], valid on the last stage only (zeros elsewhere):
    reduce it with `last_stage_value` or seed the loss with
    `stage_loss`. `stage_fn(params, h) -> h` keeps the width d."""
    B, d = x.shape
    M, N = num_microbatches, num_stages
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} micro-batches")
    mb = B // M
    xs = x.reshape(M, mb, d)
    is_first = _flag(comm.rank == 0, x)
    is_last = _flag(comm.rank == N - 1, x)
    state = x.new_zeros((mb, d))
    outputs = [x.new_zeros((mb, d)) for _ in range(M)]
    for t in range(M + N - 1):
        out = stage_fn(my_params, torch.where(is_first, xs[t % M], state))
        slot = t - (N - 1)     # completes at the last stage on tick t
        if slot >= 0:
            outputs[slot] = torch.where(is_last, out, outputs[slot])
        state = ppermute(out, comm)
    return torch.cat(outputs).reshape(B, d)


def last_stage_value(y: torch.Tensor, comm, num_stages: int
                     ) -> torch.Tensor:
    """The last stage's pipeline output on every rank of the pp group.
    For inference and metrics, outside the loss's gradient."""
    keep = _flag(comm.rank == num_stages - 1, y)
    return comm.all_reduce_(torch.where(keep, y, torch.zeros_like(y))
                            .detach().contiguous())


def stage_loss(loss_fn: Callable[[torch.Tensor], torch.Tensor],
               y: torch.Tensor, comm, num_stages: int) -> torch.Tensor:
    """loss_fn(y) on the last stage, 0.0 elsewhere: seeding the loss on
    the last stage alone makes autograd through the pipeline's shifts
    count each sample once (the TP tower's disjoint-loss rule). Sum the
    value over the pp group after the backward to report it."""
    v = loss_fn(y)
    return torch.where(_flag(comm.rank == num_stages - 1, v), v,
                       torch.zeros_like(v))


def _dp_avg(params: Dict[str, torch.Tensor], dp_comm
            ) -> Dict[str, torch.Tensor]:
    return {k: (dp_comm.all_reduce_(v.detach().clone()) / dp_comm.size)
            .to(v.dtype) for k, v in params.items()}


def pipedream_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                    loss_fn: Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor],
                    my_params, x: torch.Tensor, targets: torch.Tensor,
                    comm, num_stages: int, num_microbatches: int,
                    update_fn: Callable[[Any, Any], Any],
                    dp_comm=None, dp_sync_every: int = 1):
    """PipeDream 1F1B with weight stashing over a stream of M
    micro-batches, then the drain. Returns (this stage's new params,
    losses [M] valid on the last stage: sum them over the pp group to
    read them everywhere).

    Per slot t at stage s (the module's timetable): the forward of
    micro-batch f = (t - s) / 2 with the current weights, stashing
    (input, weights) at f % N; the backward of b = (t - (2N - 1 - s)) / 2
    recomputed from stash slot b % N, dL/dy seeded locally on the last
    stage, then params <- update_fn(params, grads). `update_fn` returns
    new tensors and owns the optimizer; with a dp group it sums the grads
    over it (lockstep replicas). With `dp_comm`, HetPipe: update_fn stays
    local and each stage's params are averaged over `dp_comm` after every
    `dp_sync_every`-th update and at the drain."""
    B, d = x.shape
    M, N = num_microbatches, num_stages
    if B % M:
        raise ValueError(f"stream {B} not divisible by {M} micro-batches")
    mb = B // M
    xs = x.reshape(M, mb, d)
    tgts = targets.reshape(M, mb, *targets.shape[1:])
    s = comm.rank
    params = dict(my_params)
    stash_w: list = [None] * N
    stash_x: list = [None] * N
    fwd_state = x.new_zeros((mb, d))
    bwd_state = x.new_zeros((mb, d))
    losses = torch.zeros(M, dtype=torch.float32, device=x.device)
    for t in range(2 * (M + N - 1)):
        # forward half: F(s, f) at t = s + 2f
        rel_f = t - s
        f = max(rel_f, 0) // 2
        out = x.new_zeros((mb, d))
        if rel_f >= 0 and rel_f % 2 == 0 and f < M:
            x_in = xs[f] if s == 0 else fwd_state
            with torch.no_grad():
                out = stage_fn(params, x_in)
            stash_x[f % N], stash_w[f % N] = x_in, params
        # backward half: B(s, b) at t = 2N - 1 - s + 2b
        rel_b = t - (2 * N - 1 - s)
        b = max(rel_b, 0) // 2
        gx = x.new_zeros((mb, d))
        if rel_b >= 0 and rel_b % 2 == 0 and b < M:
            w_b = {k: v.detach().requires_grad_(True)
                   for k, v in stash_w[b % N].items()}
            x_b = stash_x[b % N].detach().requires_grad_(True)
            with torch.enable_grad():
                y = stage_fn(w_b, x_b)
                if s == N - 1:
                    loss_b = loss_fn(y, tgts[b])
                    seed = torch.autograd.grad(loss_b, y,
                                               retain_graph=True)[0]
                    losses[b] = loss_b.detach().float()
                else:
                    seed = bwd_state
                grads = torch.autograd.grad(y, [*w_b.values(), x_b], seed)
            gx = grads[-1]
            params = update_fn(params, dict(zip(w_b, grads[:-1])))
            if dp_comm is not None and (b + 1) % dp_sync_every == 0:
                params = _dp_avg(params, dp_comm)
        fwd_state = comm.shift(out, 1)
        bwd_state = comm.shift(gx, -1)
    if dp_comm is not None:
        params = _dp_avg(params, dp_comm)   # the drained stream ends synced
    return params, losses


def hetpipe_apply(stage_fn, loss_fn, my_params, x, targets, comm, dp_comm,
                  num_stages: int, num_microbatches: int, update_fn,
                  sync_every: int = 1):
    """HetPipe (WSP): PipeDream 1F1B per pipeline replica, with each
    stage's params averaged over its dp replica group `dp_comm` every
    `sync_every` micro-batch updates and at the drain. `update_fn` must
    be local (no dp sum). See `pipedream_apply`."""
    return pipedream_apply(stage_fn, loss_fn, my_params, x, targets, comm,
                           num_stages, num_microbatches, update_fn,
                           dp_comm=dp_comm, dp_sync_every=sync_every)
