"""Engine, local mode (port of `herald_tpu/train/engine.py`).

One device, the whole table on it. Every step reads the batch's rows by
position: one K1 launch (`ops/kernels/gather.py`) over the `B*F` ids
writes the tower's f32 `[B, F, W]` input, as the JAX one-device SGD path
reads `table[ids]` and casts it (`engine.py:433-434`). The eval step
(`predict`, `evaluate`) runs the tower and a sigmoid on it, with no dedup.
The train step (`train_step`, `train_epoch`) adds the backward pass and
the sparse update, over a static-size dedup of the ids
(`ops.embedding.unique_static`, JAX's `jnp.unique(size=B*F,
fill_value=-1)`):

- SGD on the table (the JAX fast path, `engine.py:427-453`): the
  duplicate-id gradients are summed over the inverse through K3
  (`ops/kernels/segment.py`), and K2 (`ops/kernels/scatter.py`) adds
  `-lr * g` to each distinct row, scaling by the 0-d `lr` itself, and
  skips the -1 slots. JAX adds every duplicate's `-lr * g` straight into
  the table instead: the same sum, with one rounding per row here where
  JAX rounds once per duplicate.
- Every other table optimizer (the dedup path, `engine.py:315-355`): the
  emb gradient is rounded to the table dtype, as autograd rounds that of
  JAX's `emb.astype(f32)` (`engine.py:388-394`); K3 sums it per unique
  id, the rows and slots are read through K1, `apply_rows` updates them,
  and `write_rows` writes them back (JAX's scatter-set with
  `mode="drop"`, outside any Pallas kernel).

No step waits for the card: every shape is fixed, and a dropped write is
redirected on the card rather than filtered on the host. On the card
each step runs as a CUDA graph (`train/graphs.py`, the counterpart of
JAX's compiled steps): its inputs go in one packed copy, and the state's
tensors are the graph's state. `Engine(..., cuda_graphs=False)` runs the
same bodies uncaptured, for checks; on the CPU they always run so.

A step updates the table, its slots, the dense params and the step in
place, and the dense slots are new tensors (copied back into the old
ones under a graph): JAX donates the state to the step, so the state
handed in is consumed in both packages.

`comm_mode="hybrid"` is JAX's hybrid mode over `torch.distributed`
(`parallel/comm.py`): the table is row-sharded over the group's S ranks
(rank r holds block r of the physical array, `[rows_per_shard, W]`, and
its slots), the tower is replicated, and every entry point takes the
global batch (`batch_size * S` rows), of which rank r runs block r, as
JAX's `P("dp")` gives. One step body serves every S and branches on
the exchange, as JAX's does on `num_shards`. A step
(`engine.py:357-425`): the static-size
dedup, `route_ids` and `owner_rows` (the owner's K1 read and the return
all-to-all), one K1 read of the returned buffer by position into the
tower's f32 input; the loss scaled by 1/S; the dense grads, the loss and
the overflow summed in one all-reduce of one flat buffer; K3 sums the
duplicate-id grads, `scatter_grads` sends them to their owners and sums
them there (K3), the owner's rows and slots are read through K1, moved
by `apply_rows` under every optimizer (JAX's SGD fast path is one-device
only) and written back by `write_rows`. The dense-sync relaxation
(`dense_sync_every`, `dense_sync_group`) is JAX's. At S > 1 the steps run
uncaptured (gloo cannot be captured), and `predict` and `evaluate` read
the eval exchange's overflow back from the card and raise on one. At
S = 1 hybrid is the local engine, as in JAX.

`mp_shards` = mp > 1 adds JAX's tensor-parallel tower
(`engine.py:369-409`): the S ranks form a (S / mp, mp) grid
(`Comm.grid`: the mp group is mp consecutive ranks, the dp group the
ranks mp apart), the table and the exchange stay row-sharded over all S,
and each col/row tower param (and its slots) keeps only this rank's
shard of the one-device engine's values (`models` `tp_plan`). A step
gathers the embeddings and dense features over the mp group
(`parallel/tp.gather_batch`), runs `apply_tp` on the group's batch and
takes this rank's chunk of the logits, so each rank's loss covers its
own samples (scaled by 1/S). The sharded params' grads are summed over
the dp group in one all-reduce, the replicated ones with the loss and
the overflow over the whole group in another.

A multi-hot model (`ModelDef.bags`, DLRM-DCNv2) runs at one rank only:
every step reads its bags through K1's pooled form
(`ops/kernels/gather.py` `gather_pool_rows`), one launch that writes each
bag's f32 sum `[B, bags, W]` (no `[B, P, W]` by position), and the tower
is the model's `apply_pooled`. The train step's backward hands K3 the
pooled gradient and each position's bag row (`segment_sum_grads`'s
`rows`), so each position's gradient is read through K3's map and never
copied out. The hybrid engine over S > 1 ranks, the tensor-parallel
tower, the cached engine (`train/cached.py`) and FAE refuse such a model.

Entry points run on the card unless the caller passes `device="cpu"`;
with no device given and no card present they raise.
"""

from __future__ import annotations

import warnings
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from herald_tpu_torch.config import HeraldConfig
from herald_tpu_torch.models.base import ModelDef, bce_with_logits, get_model
from herald_tpu_torch.ops.embedding import segment_sum_grads, unique_static
from herald_tpu_torch.ops.kernels import (embedding_gather, gather_pool_rows,
                                          rows_scatter_add)
from herald_tpu_torch.optim import get_optimizer
from herald_tpu_torch.optim.schedules import get_schedule
from herald_tpu_torch.parallel import tp
from herald_tpu_torch.parallel.comm import setup as setup_comm
from herald_tpu_torch.parallel.exchange import (make_exchange, owner_rows,
                                                route_ids, scatter_grads)
from herald_tpu_torch.train.graphs import (TORCH_DTYPES, PackedSteps,
                                           StepGraphs, feed_inputs, pack,
                                           pack_tensors)
from herald_tpu_torch.utils import metrics as M
from herald_tpu_torch.utils.profiler import span, spanned

# logical table rows drawn at a time by `Engine.init_state`
INIT_CHUNK_ROWS = 1 << 20


class TrainState(NamedTuple):
    """All trainable state, as in the JAX package (`engine.py:38-44`)."""
    table: torch.Tensor                  # [padded_rows, width]
    table_slots: Dict[str, torch.Tensor]
    dense: Dict[str, torch.Tensor]
    dense_slots: Dict[str, Dict[str, torch.Tensor]]
    step: torch.Tensor                   # 0-d int32


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when none is given. Never falls back to the
    CPU: with no device and no card it raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "herald_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def write_rows(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
               keep: Optional[torch.Tensor] = None) -> None:
    """dst[idx] = vals in dst's dtype, dropping the entries outside dst or,
    when given, where `keep` is False (the JAX `.at[].set(mode="drop")`),
    at fixed shapes and with no wait for the card. A dropped entry takes a
    kept entry's index and value, so `index_copy_`'s duplicates write the
    same bytes; the dropped entries are spread over the kept ones in turn
    (the j-th over kept entry j mod kept), since thousands of writes to
    one row serialize on the card. With none kept, row 0's own value goes
    back into row 0. A dropped entry changes no bit of dst."""
    n = idx.shape[0]
    if n == 0:
        return
    if keep is None:
        keep = (idx >= 0) & (idx < dst.shape[0])
    pos = torch.arange(n, device=idx.device)
    rank = torch.cumsum(keep, 0)            # kept entries before, and it
    kept = rank[-1:]
    # kept entry r (from 0) at position at[r]; the dropped ones at n
    at = torch.zeros(n + 1, dtype=torch.long, device=idx.device).scatter_(
        0, torch.where(keep, rank - 1, n), pos)
    src = torch.where(keep, pos, at.index_select(0, pos % kept.clamp(min=1)))
    any_kept = kept > 0
    tgt = torch.where(any_kept, idx.index_select(0, src), 0).long()
    dst.index_copy_(0, tgt, torch.where(
        any_kept[:, None], vals.index_select(0, src).to(dst.dtype), dst[:1]))


def refuse_bags(model: ModelDef, engine: str) -> None:
    """Raise for a multi-hot model (`ModelDef.bags`) on an engine that
    reads and plans one id a field: the cached engine and FAE."""
    if model.bags is not None:
        raise NotImplementedError(
            f"model {model.name!r} reads multi-hot bags, which {engine} "
            f"does not: train it on the plain engine (ROADMAP item 46)")


class Engine:
    """Trains and scores one model over a table on one device, or over a
    table row-sharded across the ranks of a process group
    (`comm_mode="hybrid"`)."""

    def __init__(self, cfg: HeraldConfig, model: Optional[ModelDef] = None,
                 table_rows: Optional[int] = None, device=None,
                 cuda_graphs: bool = True):
        if cfg.comm_mode not in ("local", "hybrid"):
            raise ValueError(f"comm_mode={cfg.comm_mode!r}: 'local' or "
                             f"'hybrid'")
        self.cfg = cfg
        self.model = model or get_model(cfg.model)
        if cfg.comm_mode == "hybrid":
            # the group of torch.distributed.run, or one already made in
            # the process; with neither, one rank (JAX's one-device mesh)
            self.comm = setup_comm(device or cfg.device)
            self.device = self.comm.device
        else:
            self.comm = None
            self.device = resolve_device(device or cfg.device)
        # the tower runs in f32 and is held to the JAX package at f32
        # tolerances: keep TF32 out of matrix products and convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.width = self.model.emb_width(cfg.embedding_dim)
        self.num_rows = table_rows or self.model.table_rows
        self.num_shards = self.comm.size if self.comm else 1
        self.rank = self.comm.rank if self.comm else 0
        # the tensor-parallel tower over the (dp, mp) grid of the ranks
        self.mp = cfg.mp_shards if cfg.comm_mode == "hybrid" else 1
        self.mp_comm = self.dp_comm = None
        if self.mp > 1:
            self._validate_tp()
            self.mp_comm, self.dp_comm = self.comm.grid(self.mp)
        self.dp_shards = self.num_shards // self.mp
        self._init_bags()
        # what checkpoints need of the layout: (tp_plan, mp), or None
        self.tp_layout = (self.model.tp_plan, self.mp) if self.mp > 1 \
            else None
        self.ids_per_worker = cfg.batch_size * self.model.spec.num_sparse
        # the table pads to S blocks of a multiple of 8 rows
        # (parallel/exchange.py:93-94), so checkpoints interchange
        self.exchange = make_exchange(
            self.num_rows, self.num_shards, self.ids_per_worker,
            cfg.a2a_capacity_factor, cfg.a2a_pull_capacity)
        # evaluation pulls every unique id: worst-case factor sizing even
        # when the train exchange is sized tight (engine.py:89-97)
        self.eval_exchange = make_exchange(
            self.num_rows, self.num_shards, self.ids_per_worker,
            cfg.a2a_capacity_factor)
        self.padded_rows = self.exchange.padded_rows
        self.dense_opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
        self.embed_opt = get_optimizer(cfg.embed_optimizer,
                                       cfg.embed_learning_rate)
        sched_kw = cfg.lr_schedule_kwargs or {}
        self._lr_fn = get_schedule(cfg.lr_schedule, cfg.learning_rate,
                                   **sched_kw)
        self._elr_fn = get_schedule(cfg.lr_schedule,
                                    cfg.embed_learning_rate, **sched_kw)
        self._fast_local_sgd = (self.num_shards == 1
                                and self.embed_opt.name == "sgd"
                                and not cfg.use_cache)
        # a one-device step's overflow count: no exchange, so always 0;
        # over S ranks, the eval exchange's since the last readback
        self._zero = torch.zeros((), dtype=torch.int32, device=self.device)
        self._eval_overflow = torch.zeros_like(self._zero)
        self._init_dsync()
        # the steps' CUDA graphs on a card; cuda_graphs=False runs the same
        # bodies uncaptured there, as on the CPU. Steps over several ranks
        # run uncaptured (gloo's collectives cannot be captured)
        self.graphs = (StepGraphs(self.device)
                       if cuda_graphs and self.device.type == "cuda"
                       and self.num_shards == 1 else None)

    def _init_bags(self):
        """A multi-hot model's bags: the offsets the pooled read takes, on
        the device, and the position -> pooled row maps of K3 (`_pos_rows`,
        one per batch size, made at a step's first, uncaptured run). One
        rank only."""
        self.bags = self.model.bags
        if self.bags is None:
            return
        if self.num_shards > 1:
            raise NotImplementedError(
                f"model {self.model.name!r} reads multi-hot bags, which run "
                f"at one rank only; {self.num_shards} ranks given "
                f"(ROADMAP item 45)")
        self._bag_offsets = torch.tensor(
            np.concatenate([[0], np.cumsum(self.bags)]), dtype=torch.int32,
            device=self.device)
        self._pos_rows_by_batch: Dict[int, torch.Tensor] = {}

    def _pos_rows(self, batch: int) -> torch.Tensor:
        """int32 [batch * P]: position p's row in the pooled [batch * bags,
        W] (sample p // P, bag of p % P)."""
        rows = self._pos_rows_by_batch.get(batch)
        if rows is None:
            nb = len(self.bags)
            bag_of = np.repeat(np.arange(nb), self.bags)
            rows = torch.tensor(
                (np.arange(batch)[:, None] * nb + bag_of[None]).reshape(-1),
                dtype=torch.int32, device=self.device)
            self._pos_rows_by_batch[batch] = rows
        return rows

    def _validate_tp(self):
        """mp_shards > 1 (engine.py:185-213, with the mesh's own check):
        the model has a Megatron tower, mp divides the ranks, the tower's
        params are a flat dict and every sharded dim divides by mp."""
        from herald_tpu_torch.models.base import available_models
        if self.model.apply_tp is None or not self.model.tp_plan:
            tp_models = [m for m in available_models()
                         if get_model(m).apply_tp is not None]
            raise ValueError(
                f"model {self.model.name!r} has no tensor-parallel tower; "
                f"models supporting mp_shards > 1: {tp_models}")
        if self.num_shards % self.mp:
            raise ValueError(f"{self.num_shards} devices not divisible by "
                             f"mp_shards={self.mp}")
        shapes = self.model.init_dense(torch.Generator().manual_seed(0),
                                       self.cfg.embedding_dim)
        if not isinstance(shapes, dict) or not all(
                isinstance(v, torch.Tensor) for v in shapes.values()):
            raise ValueError(
                f"model {self.model.name!r}: TP towers must keep dense "
                f"params as a flat dict (tp_plan maps its keys)")
        for k, kind in self.model.tp_plan.items():
            s = tuple(shapes[k].shape)
            ax = tp.shard_axis(kind, len(s))
            if ax is not None and s[ax] % self.mp:
                raise ValueError(
                    f"param {k!r} ({kind}-parallel, shape {s}) not "
                    f"divisible by mp_shards={self.mp}")

    def _tp_kind(self, name: str) -> str:
        """"col", "row" or "rep": how param `name` lies over the mp group
        ("rep" at mp = 1)."""
        return "rep" if self.mp == 1 else tp.plan_kind(self.model.tp_plan,
                                                      name)

    def global_dense(self, dense: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The whole tower from this rank's shards: each col or row param
        gathered over the mp group (every rank of the group calls it), the
        rest as it is; at mp = 1 `dense` itself."""
        if self.mp == 1:
            return dense
        axes = {k: tp.shard_axis(self._tp_kind(k), v.dim())
                for k, v in dense.items()}
        return {k: v if axes[k] is None else
                self.mp_comm.all_gather(v, axes[k])
                for k, v in dense.items()}

    def _tower(self, params, emb, dense_x):
        """Logits [B] of this rank's batch: `apply`, or at mp > 1 the
        Megatron tower over the mp group's batch and this rank's chunk of
        its logits (engine.py:377-385, 470-478)."""
        if self.mp == 1:
            tower = self.model.apply if self.bags is None \
                else self.model.apply_pooled
            return tower(params, emb, dense_x)
        c = self.mp_comm
        # `emb` in the table's dtype: gathered so and widened after, so
        # the backward's reduce-scatter runs in that dtype too
        logits = self.model.apply_tp(
            params, tp.gather_batch(emb, c).to(torch.float32),
            tp.gather_batch(dense_x, c), c)
        return tp.my_batch_chunk(logits, emb.shape[0], c)

    # ------------------------------------------------------------------
    # dense-sync relaxation (engine.py:104-183)
    # ------------------------------------------------------------------
    def _init_dsync(self):
        """`dense_sync_every` k and `dense_sync_group` g: the dense grads
        summed over static subgroups of g ranks each step, and the whole
        group's dense params and slots averaged every k steps and at the
        end of each `train_epoch`. Every rank makes every subgroup, in one
        order."""
        cfg = self.cfg
        S = self.num_shards
        self.dsync_k = cfg.dense_sync_every
        g = cfg.dense_sync_group or S
        if S > 1 and g > S:
            raise ValueError(f"dense_sync_group={g} exceeds the dp axis "
                             f"({S} workers)")
        self.dsync_g = g if S > 1 else 1
        self._dsync_on = S > 1 and (self.dsync_k > 1 or self.dsync_g < S)
        self._dsync_comm = None
        if not self._dsync_on:
            return
        if S % self.dsync_g:
            raise ValueError(f"dense_sync_group={self.dsync_g} does not "
                             f"divide the dp axis ({S} workers)")
        if g < S:
            self._dsync_comm = self.comm.split(
                [list(range(a, a + g)) for a in range(0, S, g)])
        if self.dsync_k == 1:
            warnings.warn(
                "dense_sync_group with dense_sync_every=1 averages the "
                "full model every step — MORE collective bytes than exact "
                "BSP. Useful for equivalence testing only; set "
                "dense_sync_every > 1 for the traffic saving.",
                UserWarning, stacklevel=3)

    def _warn_per_step_dsync(self):
        """A single step must leave the dense state replicated, so it
        averages every step; k > 1 takes effect in `train_epoch` only."""
        if (self._dsync_on and self.dsync_k > 1
                and not getattr(self, "_dsync_warned", False)):
            self._dsync_warned = True
            warnings.warn(
                "dense_sync_every > 1 cannot defer syncs on per-step "
                "dispatch (every step is a jit boundary and must end "
                "replicated) — this path averages the model every step; "
                "use the scanned train_epoch* entry points for the "
                "traffic saving", UserWarning, stacklevel=3)

    def _sync_dense(self, state: TrainState) -> None:
        """Average the dense params and their slots over the whole group,
        in place: one all-reduce of one flat buffer, then / S."""
        ts = [*state.dense.values(),
              *(v for s in state.dense_slots.values() for v in s.values())]
        flat = torch.cat([t.reshape(-1) for t in ts])
        self.comm.all_reduce_(flat).div_(self.num_shards)
        for t, v in zip(ts, torch.split(flat, [t.numel() for t in ts])):
            t.copy_(v.view(t.shape))

    def _reduce(self, dgrads, loss, overflow):
        """(dense grads, the step's result). Over S ranks the result is f32
        [loss, overflow] (`overflow`: the step's dropped ids on this rank),
        summed over the group; on one device (`overflow` None) the grads
        are as they are and the result is the loss alone (no overflow, and
        no kernel to make one). The grads of the tower's col and row shards
        (mp > 1) already hold the whole mp group's samples (the tower's
        collectives mixed them), so they are summed over the dp group in
        one all-reduce; the rest hold this rank's samples only and go over
        the whole group with [loss, overflow] in another (engine.py:
        397-407); at mp = 1 that is every grad, in one call. Under a
        dense-sync subgroup the grads go over it instead and are scaled by
        S/g (the loss was scaled by 1/S, so the group's sum is g/S of its
        mean), and the loss and overflow take a second call."""
        if overflow is None:
            return dgrads, loss
        stats = torch.stack([loss.to(torch.float32),
                             overflow.to(torch.float32)])
        out = {}
        if self._dsync_comm is not None:
            names = list(dgrads)
            out.update(zip(names, self._sum_packed(
                self._dsync_comm, [dgrads[k] for k in names],
                self.num_shards / self.dsync_g)))
            stats = self.comm.all_reduce_(stats)
        else:
            sharded = [k for k in dgrads if self._tp_kind(k) != "rep"]
            rep = [k for k in dgrads if self._tp_kind(k) == "rep"]
            out.update(zip(sharded, self._sum_packed(
                self.dp_comm, [dgrads[k] for k in sharded])))
            *grads, stats = self._sum_packed(
                self.comm, [dgrads[k] for k in rep] + [stats])
            out.update(zip(rep, grads))
        return {k: out[k] for k in dgrads}, stats

    @staticmethod
    def _sum_packed(comm, ts, scale=None):
        """`ts` summed over `comm` (times `scale` when given) in one
        all-reduce of one flat buffer, as views of it; none for none."""
        if not ts:
            return []
        flat = comm.all_reduce_(torch.cat([t.reshape(-1) for t in ts]))
        if scale is not None:
            flat.mul_(scale)
        return [v.view(t.shape) for t, v in zip(
            ts, torch.split(flat, [t.numel() for t in ts]))]

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Random state from a seed: table ~ 0.01 * N(0, 1), generated
        directly in `table_dtype` on the device (no f32 intermediate: at
        full width that would be 17 GB), zero table slots in the table
        dtype, then the tower and its zero slots (`{name: {}}` for a
        slotless optimizer, as JAX's tree has it). The table is one
        logical table at every S: its first ceil8(num_rows) logical rows
        are drawn from `seed` in chunks of INIT_CHUNK_ROWS, and each rank
        keeps its strided rows (its block's other slots stay zero), so the
        peak is one block and one chunk. The tower is drawn from the same
        generator after the table, so it too is the one-device engine's;
        over S > 1 ranks rank 0's tower and slots are broadcast as well, so
        that they are identical on every rank. At mp > 1 each rank then
        keeps its shard of each col/row param and its slots
        (engine.py:258-271)."""
        seed = self.cfg.seed if seed is None else seed
        S, W = self.num_shards, self.width
        gen = torch.Generator(device=self.device).manual_seed(seed)
        table = torch.zeros((self.exchange.rows_per_shard, W),
                            dtype=self.cfg.table_dtype, device=self.device)
        drawn = -(-self.num_rows // 8) * 8
        for c0 in range(0, drawn, INIT_CHUNK_ROWS):
            c1 = min(c0 + INIT_CHUNK_ROWS, drawn)
            chunk = torch.randn((c1 - c0, W), generator=gen,
                                dtype=self.cfg.table_dtype,
                                device=self.device)
            first = c0 + (self.rank - c0) % S     # this rank's first row
            rows = chunk[first - c0::S]
            table[first // S:first // S + rows.shape[0]] = rows
        table.mul_(0.01)
        slots = {k: torch.zeros_like(table)
                 for k in self.embed_opt.slot_names}
        dense = self.model.init_dense(gen, self.cfg.embedding_dim)
        dense_slots = {k: self.dense_opt.init_slots(v)
                       for k, v in dense.items()}
        if S > 1:
            self.comm.broadcast_([*dense.values(), *(
                v for s in dense_slots.values() for v in s.values())])
        if self.mp > 1:
            plan, j = self.model.tp_plan, self.mp_comm.rank
            dense = {k: v.contiguous() for k, v in
                     tp.cut(dense, plan, self.mp, j).items()}
            dense_slots = {k: {n: x.contiguous() for n, x in v.items()}
                           for k, v in tp.cut(dense_slots, plan, self.mp,
                                              j).items()}
        step = torch.zeros((), dtype=torch.int32, device=self.device)
        return TrainState(table=table, table_slots=slots, dense=dense,
                          dense_slots=dense_slots, step=step)

    # ------------------------------------------------------------------
    def _read(self, table, ids):
        """ids [B, F] -> f32 [B, F, W]: one K1 read by position, widened in
        the kernel; ids outside the table give zero rows (the JAX engine's
        `mode="fill"` read). A row that several positions read comes from
        the card's L2 after the first, so on one device a dedup would save
        the read nothing (the JAX eval path dedups for its multi-shard
        exchange, `engine.py:301-313`). A multi-hot model's ids [B, P] give
        its pooled bags, f32 [B, bags, W], in one launch of K1's pooled
        form."""
        if self.bags is not None:
            return gather_pool_rows(table, ids, self._bag_offsets)
        B, F = ids.shape
        emb = embedding_gather(table, ids.reshape(-1), torch.float32)
        return emb.reshape(B, F, self.width)

    def _sparse_read(self, table, ids, spec):
        """ids [B, F] -> (emb [B, F, W], uniq [B*F], inv, route): the
        static-size dedup (-1 in the spare slots) that the sparse update
        sums and writes over, and the tower's input, in f32 (at mp > 1 in
        the table's dtype, which `_tower` widens after its gather). On one
        device the rows are read by position from the table and `route`
        is None. Over S ranks the unique ids are routed to their owners
        through `spec`'s exchange, the owners' rows come back in the
        [S*C, W] send-slot buffer, and one K1 read of it by position
        (`pos[inv]`; a dropped id's S*C reads a zero row) writes the
        tower's input (engine.py:295-313)."""
        B, F = ids.shape
        uniq, inv = unique_static(ids, ids.numel())
        if self.num_shards == 1:
            return self._read(table, ids), uniq, inv, None
        route = route_ids(spec, uniq, uniq >= 0, self.comm)
        back = owner_rows(spec, table, route, self.comm)
        emb = embedding_gather(back, route.pos[inv],
                               torch.float32 if self.mp == 1 else None)
        return emb.view(B, F, self.width), uniq, inv, route

    def _loss_and_grads(self, dense, emb, dense_x, labels, scale=None):
        """(loss, {name: dense grad}, emb grad): `value_and_grad` with
        respect to the dense params and the f32 `emb`, of the loss times
        `scale` when given (1/S over S ranks, as JAX scales it)."""
        params = {k: v.detach().requires_grad_(True)
                  for k, v in dense.items()}
        emb = emb.detach().requires_grad_(True)
        with torch.enable_grad():
            logits = self._tower(params, emb, dense_x)
            loss = bce_with_logits(logits, labels)
            if scale is not None:
                loss = loss * scale
            grads = torch.autograd.grad(loss, [*params.values(), emb])
        return loss.detach(), dict(zip(params, grads[:-1])), grads[-1]

    def _apply_sparse_grads(self, table, slots, step, uniq, inv, emb_grad,
                            route=None, pos_rows=None):
        """Sum the grads per unique id (K3, in f32, rounded once to the
        grads' dtype), cast the sums to the table dtype, update the rows
        and slots with the table optimizer, write them back. In place.
        Slots of negative ids (the dedup's spare slots, the FAE step's -1
        at hot positions) are masked and dropped. With a `route` (S > 1)
        the sums go to their owners first in the grads' dtype
        (`scatter_grads`; the FAE step's f32, as JAX's wire carries them)
        and are cast there, and the rows updated are the owner's
        (engine.py:315-355). `pos_rows` maps each position to its row of
        a pooled `emb_grad` (a multi-hot model's)."""
        g_uniq = segment_sum_grads(emb_grad, inv, uniq.shape[0], pos_rows)
        if route is None:
            rows_idx, row_grads, row_mask = uniq, g_uniq, uniq >= 0
            keep = row_mask & (uniq < table.shape[0])
        else:
            rows_idx, row_grads, _, row_mask = scatter_grads(
                self.exchange, route, g_uniq, self.comm)
            keep = row_mask
        row_grads = row_grads.to(table.dtype)
        safe_idx = torch.where(row_mask, rows_idx, 0)
        rows = embedding_gather(table, safe_idx)
        row_slots = {k: embedding_gather(v, safe_idx)
                     for k, v in slots.items()}
        new_rows, new_slots = self.embed_opt.apply_rows(
            rows, row_grads, row_slots, step,
            lr=self._elr_fn(step), mask=row_mask)
        write_rows(table, rows_idx, new_rows, keep)
        for k in slots:
            write_rows(slots[k], rows_idx, new_slots[k], keep)
        return table, slots

    def _rank_block(self, x, dtype, axis: int = 0) -> np.ndarray:
        """This rank's block of a global host batch along `axis` ([W, B,
        ...] flattens to [W*B, ...] first when axis is 0)."""
        a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        if axis == 0 and a.ndim >= 3:
            a = a.reshape(a.shape[0] * a.shape[1], *a.shape[2:])
        n = a.shape[axis]
        if n % self.num_shards:
            raise ValueError(f"a global batch of {n} rows does not split "
                             f"over {self.num_shards} ranks")
        b = n // self.num_shards
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(self.rank * b, (self.rank + 1) * b)
        return a[tuple(idx)].astype(dtype, copy=False)

    def _check_eval_overflow(self) -> None:
        """JAX's readback of the eval exchange's overflow since the last
        check, summed over the group (engine.py:673-681): a dropped id
        would score on a zero row."""
        total = self.comm.all_reduce_(
            self._eval_overflow.to(torch.float32).reshape(1))
        self._eval_overflow.zero_()
        if int(total) > 0:
            raise RuntimeError(
                "eval exchange overflow: predictions would be computed "
                "on zero-filled embeddings; raise a2a_capacity_factor")

    def _train_step_body(self, state: TrainState, a):
        """One step on this rank's inputs `a` ("d", "s", "y"): (state,
        result), the result as `_reduce` gives it: the loss on one device,
        [loss, overflow] summed over the group over S ranks
        (engine.py:357-425)."""
        step = state.step.add_(1)
        emb, uniq, inv, route = self._sparse_read(state.table, a["s"],
                                                  self.exchange)
        loss, dgrads, emb_grad = self._loss_and_grads(
            state.dense, emb, a["d"], a["y"],
            scale=None if route is None else 1.0 / self.num_shards)
        dgrads, res = self._reduce(dgrads, loss,
                                   None if route is None else route.overflow)
        dense, dense_slots = self.dense_opt.apply_dense(
            state.dense, dgrads, state.dense_slots, step,
            lr=self._lr_fn(step), in_place=True)
        # a multi-hot model's grads are its pooled bags': each position
        # reads its bag's row through K3's map
        pos_rows = None if self.bags is None else self._pos_rows(
            a["s"].shape[0])
        if self._fast_local_sgd:
            # SGD on the table: the f32 emb grads (JAX casts the gather to
            # f32 before `value_and_grad`) summed per distinct id through
            # K3, and `-lr * g` added through K2
            g_uniq = segment_sum_grads(emb_grad, inv, uniq.shape[0],
                                       pos_rows)
            table = rows_scatter_add(state.table, uniq, g_uniq,
                                     lr=self._elr_fn(step))
            table_slots = state.table_slots
        else:
            # the grad of a table-dtype leaf cast to f32, as JAX's is
            table, table_slots = self._apply_sparse_grads(
                state.table, state.table_slots, step, uniq, inv,
                emb_grad.to(state.table.dtype), route, pos_rows)
        return TrainState(table=table, table_slots=table_slots, dense=dense,
                          dense_slots=dense_slots, step=step), res

    def _eval_step_body(self, state: TrainState, a):
        """Probabilities [B] of this rank's inputs `a` ("d", "s"): (state,
        probs). Over S ranks the ids go through the eval exchange, whose
        overflow adds to `_eval_overflow` (engine.py:478-494)."""
        if self.num_shards == 1:
            emb = self._read(state.table, a["s"])
        else:
            emb, _, _, route = self._sparse_read(state.table, a["s"],
                                                 self.eval_exchange)
            self._eval_overflow += route.overflow
        return state, torch.sigmoid(self._tower(state.dense, emb, a["d"]))

    # ------------------------------------------------------------------
    # feeding steps
    # ------------------------------------------------------------------
    def _run(self, name, body, state, feed, out=None, reads=()):
        """One step of `body` on a feed (`train/graphs.py`): replayed as a
        CUDA graph on a card, run as it is otherwise. (state, result)."""
        if self.graphs is not None:
            return self.graphs.run(name, body, state, feed, out, reads)
        new_state, res = body(state, feed_inputs(feed, self.device))
        return new_state, (res if out is None else out.copy_(res))

    def _host_feed(self, arrays: Dict[str, np.ndarray], steps=None):
        """Host arrays -> a feed: packed, pinned on a card, one copy."""
        return pack(arrays, steps, pin=self.device.type == "cuda")

    def _to_device(self, arrays: Dict[str, np.ndarray], steps=None):
        """Host arrays -> (packed uint8 buffer on the device, layout): ONE
        copy from pinned memory, without waiting."""
        buf, layout = self._host_feed(arrays, steps)
        return buf.to(self.device, non_blocking=True), layout

    def _batch_feed(self, spec: Dict[str, tuple]):
        """{name: (array or tensor, dtype)} of one batch -> a feed. Tensors
        on the engine's card are fed as they are; anything else is packed
        on the host. [W, B, ...] flattens to [W*B, ...] as in JAX. Over S
        ranks the batch is the global one, and this rank's block of it is
        packed on the host."""
        def flat(x):
            return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]) \
                if x.ndim >= 3 else x

        if self.num_shards > 1:     # this rank's block of the global batch
            spec = {k: (self._rank_block(x, dt), dt)
                    for k, (x, dt) in spec.items()}
        if self.device.type == "cuda" and all(
                isinstance(x, torch.Tensor) and x.is_cuda
                and self.device.index in (None, x.device.index)
                for x, _ in spec.values()):
            return {k: flat(x.to(TORCH_DTYPES[np.dtype(dt)]))
                    for k, (x, dt) in spec.items()}
        return self._host_feed({
            k: flat((x.cpu().numpy() if isinstance(x, torch.Tensor)
                     else np.asarray(x)).astype(dt, copy=False))
            for k, (x, dt) in spec.items()})

    def example_step_args(self):
        """Zero-filled device args of one train step on this rank, in the
        step body's order: `_train_step_body(state, *args)` (args is its
        one feed, this rank's block of a global batch). For counting a
        step's collective bytes: `utils.hlo_stats.collective_bytes(
        eng._train_step_body, state, *eng.example_step_args(),
        comm=eng.comm)`; the state is consumed."""
        B, spec = self.cfg.batch_size, self.model.spec

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)
        return ({"d": zeros((B, max(spec.num_dense, 0)), torch.float32),
                 "s": zeros((B, spec.num_sparse), torch.int32),
                 "y": zeros((B, 1), torch.float32)},)

    # ------------------------------------------------------------------
    def train_step(self, state: TrainState, dense_x, sparse_ids, labels):
        """One step on one global batch: (state, {"loss", "overflow"}). The
        state handed in is consumed. Over S ranks the batch is the global
        one (`batch_size * S` rows, or [S, batch_size, ...]); each rank
        runs its block, and a dense-sync relaxation averages the dense
        state after the step, as JAX's single step does."""
        self._warn_per_step_dsync()
        state, res = self._run("train", self._train_step_body, state,
                                 self._batch_feed({
                                     "d": (dense_x, np.float32),
                                     "s": (sparse_ids, np.int32),
                                     "y": (labels, np.float32)}))
        if self._dsync_on:
            self._sync_dense(state)
        if self.num_shards == 1:
            return state, {"loss": res, "overflow": self._zero}
        return state, {"loss": res[0], "overflow": res[1].to(torch.int32)}

    @spanned("train.chunk")
    def train_epoch(self, state: TrainState, dense_x, sparse_ids=None,
                    labels=None, steps: Optional[int] = None):
        """Run `steps` steps (default: as many full batches as the arrays
        hold). Host arrays are flat ([steps*B, ...]) and go to the device
        packed, one step a row, in one copy; tensors already shaped
        [steps, B, ...] are packed on their card. `dense_x` may instead be
        a `PackedSteps` staged on the engine's device ("d", "s", "y" of
        this rank's block of each step, as `data.prefetch.DevicePrefetcher`
        gives it), which runs as it is. Returns (state, stats) with
        per-step `loss` and `overflow` tensors [steps]. Each step is one
        replay of the step's graph (JAX scans the steps in one program).
        Over S ranks the arrays hold global batches of `batch_size * S`
        rows, each rank's blocks of the steps are packed on the host, and
        the steps run uncaptured; a dense-sync relaxation averages the
        dense state every `dense_sync_every` steps and at the end
        (engine.py:455-476). Under a profiler, the call is the span
        `train.chunk` (`utils/profiler.py`)."""
        S = self.num_shards
        if isinstance(dense_x, PackedSteps):
            if steps not in (None, dense_x.steps):
                raise ValueError(f"steps={steps} for a chunk of "
                                 f"{dense_x.steps} staged steps")
            return self._train_steps(state, dense_x.packed, dense_x.layout,
                                     dense_x.steps)
        gb = self.cfg.batch_size * S
        steps = steps or len(sparse_ids) // gb
        if steps < 1:
            raise ValueError(f"not enough samples for one step of {gb}")

        def staged(x):      # a tensor already shaped [steps, B, ...]
            return isinstance(x, torch.Tensor) and x.dim() >= 2 \
                and x.shape[0] == steps

        def by_step(x, dt):     # [steps, gb, ...]: this rank's block of it
            if not staged(x):
                a = np.asarray(x)[: steps * gb].astype(dt, copy=False)
                x = a.reshape(steps, gb, *a.shape[1:])
            return x if S == 1 else self._rank_block(x, dt, axis=1)

        arrays = {k: (by_step(x, dt), dt) for k, (x, dt) in {
            "d": (dense_x, np.float32), "s": (sparse_ids, np.int32),
            "y": (labels, np.float32)}.items()}
        with span("feed.pack"):
            if any(isinstance(x, torch.Tensor) for x, _ in arrays.values()):
                buf, layout = pack_tensors({
                    k: torch.as_tensor(x).to(self.device,
                                             TORCH_DTYPES[np.dtype(dt)])
                    for k, (x, dt) in arrays.items()}, steps)
            else:
                buf, layout = self._to_device(
                    {k: x for k, (x, _) in arrays.items()}, steps)
        return self._train_steps(state, buf, layout, steps)

    def _train_steps(self, state: TrainState, buf: torch.Tensor,
                     layout, steps: int):
        """`train_epoch`'s steps over a packed [steps, nbytes] buffer on
        the device."""
        S = self.num_shards
        res = torch.empty((2, steps), dtype=torch.float32,
                          device=self.device)     # loss; overflow
        # the scanned body's sync every k steps (engine.py:176-183); the
        # step count is read once a call, only when k > 1 needs it
        step0 = int(state.step) if self._dsync_on and self.dsync_k > 1 \
            else 0
        with span("step.dispatch"):
            for k in range(steps):
                state, _ = self._run("train", self._train_step_body, state,
                                     (buf[k], layout),
                                     out=res[:, k] if S > 1 else res[0, k])
                if self._dsync_on and (step0 + k + 1) % self.dsync_k == 0:
                    self._sync_dense(state)
        if self._dsync_on:
            # the chunk's end leaves the dense state replicated
            self._sync_dense(state)
        return state, {"loss": res[0], "overflow": torch.zeros(
            steps, dtype=torch.int32, device=self.device) if S == 1
            else res[1].to(torch.int32)}

    def train_epoch_assigned(self, state: TrainState, scheduler, dense_x,
                             sparse_ids, labels, steps: int):
        """Assign-only mode: `train_epoch` over the batches the lookahead
        scheduler (`sched/scheduler.py`, csrc/herald_sched.cc) composes,
        without the hot-row cache. Up to `steps` assignments are popped;
        each step trains on the samples it lists, in its order. Returns
        (state, None) when the scheduler's stream has ended. On one device
        a step's sample set is the plain step's, in another order. Over S
        ranks (the scheduler planned for S workers, e.g. through
        `sched.service.BroadcastScheduler`) the assignment [S, B] flattens
        row by row into the global batch, so rank r trains row r in its
        order, as JAX's dp split of the flattened assignment gives."""
        idx_rows = []
        for _ in range(steps):
            r = scheduler.pop()
            if r is None:
                break
            idx_rows.append(r[0].reshape(-1))
        if not idx_rows:
            return state, None
        idx = np.concatenate(idx_rows)
        return self.train_epoch(state, dense_x[idx], sparse_ids[idx],
                                labels[idx], steps=len(idx_rows))

    @torch.inference_mode()
    def predict(self, state: TrainState, dense_x, sparse_ids
                ) -> torch.Tensor:
        """Probabilities [B] of one batch, on the engine's device. Over S
        ranks the batch is the global one, every rank returns the
        probabilities of all of it (gathered from the ranks), and the eval
        exchange's overflow is read back from the card: an overflow
        raises (engine.py:673-681). On one device nothing waits for the
        card."""
        probs = self._run("eval", self._eval_step_body, state,
                          self._batch_feed({"d": (dense_x, np.float32),
                                            "s": (sparse_ids, np.int32)}))[1]
        if self.num_shards == 1:
            return probs
        self._check_eval_overflow()
        return self.comm.all_gather(probs).reshape(-1)

    @torch.inference_mode()
    def evaluate(self, state: TrainState, dense_x, sparse_ids, labels,
                 batch: Optional[int] = None) -> Dict[str, float]:
        """Full-dataset AUC and accuracy. The tail is padded to a full
        batch by repeating the last sample and its extra predictions are
        dropped, so every sample is scored once. Batches go in blocks of
        up to T=32: one copy to the device and one back per block. Over S
        ranks a batch is global, at most `batch_size * S` rows (the eval
        exchange is sized for that, engine.py:693-697): each rank scores
        its block, the probabilities are gathered, and the eval
        exchange's overflow is read back once a block and raises."""
        n = len(sparse_ids)
        if n == 0:
            return {"auc": 0.5, "acc": float("nan")}
        S = self.num_shards
        gb = self.cfg.batch_size * S
        batch = min(batch or gb, gb) if S > 1 else (batch or gb)
        nb = -(-n // batch)
        T = min(32, nb)
        blocks = -(-nb // T)
        rows = T * batch
        d_all = np.asarray(dense_x, np.float32)
        s_all = np.asarray(sparse_ids, np.int32)
        total = blocks * rows
        if total > n:
            pad = total - n
            d_all = np.concatenate([d_all,
                                    np.repeat(d_all[-1:], pad, axis=0)])
            s_all = np.concatenate([s_all,
                                    np.repeat(s_all[-1:], pad, axis=0)])
        preds = []
        for b in range(blocks):
            sl = slice(b * rows, (b + 1) * rows)
            dk = d_all[sl].reshape(T, batch, *d_all.shape[1:])
            sk = s_all[sl].reshape(T, batch, *s_all.shape[1:])
            if S > 1:       # this rank's block of each batch
                dk = self._rank_block(dk, np.float32, axis=1)
                sk = self._rank_block(sk, np.int32, axis=1)
            buf, layout = self._to_device({"d": dk, "s": sk}, T)
            p = torch.empty((T, sk.shape[1]), dtype=torch.float32,
                            device=self.device)
            for t in range(T):
                self._run("eval", self._eval_step_body, state,
                          (buf[t], layout), out=p[t])
            if S > 1:       # [S, T, b] -> the batches' sample order
                self._check_eval_overflow()
                p = self.comm.all_gather(p).permute(1, 0, 2)
            preds.append(p.reshape(-1).cpu().numpy())
        y_score = np.concatenate(preds)[:n]
        y_true = np.asarray(labels).reshape(-1)[: len(y_score)]
        return {
            "auc": M.auc_score(y_true, y_score),
            "acc": M.accuracy(y_true, y_score),
        }
