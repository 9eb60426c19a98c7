"""Distributed GCN over the ranks of a process group (port of
`herald_tpu/gnn/gcn.py`).

Full-batch semi-supervised node classification: every layer computes
h' = Ā (h W) + b, with ReLU between layers, where Ā is the normalized
adjacency of `graph.py`. Nodes are owned strided over S ranks (node v on
rank v % S, as `parallel/exchange.py` owns table rows), and each rank
aggregates into the rows it owns over the edges it owns (`partition_edges`:
by destination). The rows of h W that its edges read come in one of three
ways, JAX's three modes:

- **halo** (the default): the rows each pair of ranks trades were planned
  on the host once (`plan_halo_exchange`); the owner reads them into its
  send buffer (K1, pad slot `rows_per_shard` reads a zero row), one
  all-to-all, and the rank's own rows followed by the received ones form
  the table its edges index.
- **pull**: each step dedups the rank's source ids at a static size (JAX's
  `jnp.unique(size=uniq_cap, fill_value=N)`), routes them to their owners
  (`route_ids`) and reads the rows back (`gather_rows`: K1 at the owner,
  an all-to-all, K1 by position).
- **broadcast**: one all-gather of every rank's rows (JAX's A/B baseline).

The aggregation itself is `segment_sum(rows[idx] * w, dst, rps)`: one K1
read by position (an index outside the table reads a zero row) and one
K3 segment sum (`hot_onehot_push`; the pad destination `rps` is
dropped). JAX takes the gradient with `jax.grad` through the collectives;
here each exchange and the aggregation is an autograd Function whose
backward is the transpose of its forward: the aggregation's is one K1
read of the output gradient at `dst` and one K3 sum by `idx`; pull's
reads the gradient into the send buffer (K1), sends it back and sums it
on the owner (K3); halo's sends the received part back and sums it into
the send slots (K3); broadcast's is a reduce-scatter. Every rank enters
them in the same order. At S = 1 every exchange is the identity. On the
card each K1 and K3 call launches the kernel or raises; on the CPU the
wrappers run their plain versions.

The loss follows JAX's disjoint-loss rule: each rank seeds only its own
masked cross-entropy, divided by the train count summed over the ranks;
the loss, the parameter grads and the pull overflow are then summed over
the ranks in one all-reduce, and SGD moves every rank's replicated
parameters the same way. `h @ W` is `torch.matmul` (JAX computes it
outside any Pallas kernel), with TF32 off.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from herald_tpu_torch.ops.embedding import unique_fill
from herald_tpu_torch.ops.kernels import embedding_gather, hot_onehot_push
from herald_tpu_torch.parallel.exchange import (ExchangeSpec, Route,
                                                _all_to_all, _local_slots,
                                                gather_rows, make_exchange,
                                                route_ids)
from herald_tpu_torch.train.engine import resolve_device

from .graph import (Graph, partition_edges, plan_halo_exchange,
                    shard_node_array)

MODES = ("halo", "pull", "broadcast")


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    feat_dim: int
    hidden_dim: int
    num_classes: int
    num_layers: int = 2
    learning_rate: float = 0.5
    seed: int = 0


def init_gcn_params(cfg: GCNConfig) -> List[Tuple[torch.Tensor,
                                                  torch.Tensor]]:
    """Glorot-uniform weights and zero biases, JAX's draw: the same
    `RandomState(seed)` values in the same order, as f32 CPU tensors."""
    dims = ([cfg.feat_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
            + [cfg.num_classes])
    rng = np.random.RandomState(cfg.seed)
    params = []
    for din, dout in zip(dims[:-1], dims[1:]):
        lim = np.sqrt(6.0 / (din + dout))
        w = rng.uniform(-lim, lim, size=(din, dout)).astype(np.float32)
        params.append((torch.from_numpy(w), torch.zeros(dout)))
    return params


class Aggregate(torch.autograd.Function):
    """out = segment_sum(rows[idx] * weight, dst, num_dst): one K1 read by
    position and one K3 sum forward; one K1 read of the output gradient at
    `dst` and one K3 sum by `idx` into the rows backward. Indices outside
    `rows` read zero rows and take no gradient; destinations outside
    [0, num_dst) are dropped. The graph arrays take no gradient."""

    @staticmethod
    def forward(ctx, rows, idx, weight, dst, num_dst: int):
        ctx.save_for_backward(idx, weight, dst)
        ctx.num_rows = rows.shape[0]
        vecs = embedding_gather(rows.contiguous(), idx)
        return hot_onehot_push(dst, vecs.mul_(weight[:, None]), num_dst)

    @staticmethod
    def backward(ctx, grad):
        idx, weight, dst = ctx.saved_tensors
        g = embedding_gather(grad.contiguous(), dst).mul_(weight[:, None])
        return (hot_onehot_push(idx, g, ctx.num_rows), None, None, None,
                None)


class PullRows(torch.autograd.Function):
    """`gather_rows`: the [U, D] rows of a step's routed unique ids from
    the owners' shards. Backward: the gradient read into the send buffer
    by slot (K1; an empty slot reads a zero row), the all-to-all back, and
    the owner's K3 sum into its `rows_per_shard` rows at the received
    local slots (empty slots dropped): `scatter_grads` without its
    dedup."""

    @staticmethod
    def forward(ctx, hw_shard, spec: ExchangeSpec, route: Route, comm):
        ctx.spec, ctx.route, ctx.comm = spec, route, comm
        return gather_rows(spec, hw_shard.contiguous(), route, comm)

    @staticmethod
    def backward(ctx, grad):
        spec, route = ctx.spec, ctx.route
        S, C = spec.num_shards, spec.capacity
        send = embedding_gather(grad.contiguous(), route.src)
        recv = _all_to_all(ctx.comm, send.view(S, C, -1)).view(S * C, -1)
        local = _local_slots(spec, route.recv_ids).reshape(-1)
        return (hot_onehot_push(local, recv, spec.rows_per_shard), None,
                None, None)


class HaloTable(torch.autograd.Function):
    """[rps + S*C, D]: the rank's own rows, then the halo rows every rank
    sent it (`send_slot` [S, C]: the local slots this rank sends to each
    rank, pad `rps`, read by one K1 launch). Backward: the halo part of
    the gradient goes back by the same all-to-all and is summed into the
    send slots (K3; pad slots dropped) on top of the own part."""

    @staticmethod
    def forward(ctx, hw_shard, send_slot, comm):
        ctx.save_for_backward(send_slot)
        ctx.comm = comm
        S, C = send_slot.shape
        hw_shard = hw_shard.contiguous()
        send = embedding_gather(hw_shard, send_slot.reshape(-1))
        halo = comm.all_to_all(send.view(S, C, -1))
        return torch.cat([hw_shard, halo.view(S * C, -1)])

    @staticmethod
    def backward(ctx, grad):
        send_slot, = ctx.saved_tensors
        S, C = send_slot.shape
        rps = grad.shape[0] - S * C
        back = ctx.comm.all_to_all(grad[rps:].reshape(S, C, -1))
        return (grad[:rps] + hot_onehot_push(send_slot.reshape(-1),
                                             back.view(S * C, -1), rps),
                None, None)


class GatherAll(torch.autograd.Function):
    """[S*rps, D]: every rank's rows in rank order (`Comm.all_gather`);
    backward, the reduce-scatter of the gradient."""

    @staticmethod
    def forward(ctx, hw_shard, comm):
        ctx.comm = comm
        return comm.all_gather(hw_shard).reshape(-1, hw_shard.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.reduce_scatter(grad.contiguous()), None


def _dedup_and_route(spec: ExchangeSpec, src: torch.Tensor, uniq_cap: int,
                     comm) -> Tuple[torch.Tensor, Route]:
    """The step's unique source ids (padded with N, routed once a step for
    every layer)."""
    uniq, inv = unique_fill(src, uniq_cap, spec.num_rows)
    return inv, route_ids(spec, uniq, uniq < spec.num_rows, comm)


def gcn_forward(spec: ExchangeSpec, params, h_shard, src, dst_local, weight,
                uniq_cap: int, mode: str = "pull", halo_send=None,
                halo_idx=None, comm=None):
    """One rank's forward: (logits [rps, C], overflow [] int32 of this
    rank's pull exchange, 0 in the other modes). `halo_send` [S, C] and
    `halo_idx` [E_cap] are the rank's halo plan (halo mode)."""
    S, rps = spec.num_shards, spec.rows_per_shard
    if mode == "pull":
        inv, route = _dedup_and_route(spec, src, uniq_cap, comm)
    h = h_shard
    for i, (w, b) in enumerate(params):
        hw = h @ w
        if mode == "pull":
            rows, idx = PullRows.apply(hw, spec, route, comm), inv
        elif mode == "halo":
            rows = HaloTable.apply(hw, halo_send, comm) if S > 1 else hw
            idx = halo_idx
        else:
            # pad src N maps in bounds; its weight 0 drops it
            rows = GatherAll.apply(hw, comm) if S > 1 else hw
            idx = spec.phys_index(src)
        h = Aggregate.apply(rows, idx, weight, dst_local, rps) + b
        if i + 1 < len(params):
            h = torch.relu(h)
    ovf = route.overflow if mode == "pull" else torch.zeros(
        (), dtype=torch.int32, device=h.device)
    return h, ovf


class GCN(nn.Module):
    """Full-batch semi-supervised node classification over the ranks of
    `comm` (`parallel/comm.py`; None: one rank). Every rank builds it from
    the whole graph and keeps its own nodes and edges on `device` (default
    the comm's, else the card; `device="cpu"` runs on the CPU)."""

    def __init__(self, cfg: GCNConfig, g: Graph, comm=None,
                 capacity_factor: float = 2.0, mode: str = "halo",
                 device=None):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode={mode!r}: one of {MODES}")
        self.cfg, self.g, self.comm, self.mode = cfg, g, comm, mode
        self.device = (torch.device(device) if device is not None
                       else comm.device if comm is not None
                       else resolve_device(None))
        # the products are held to JAX's f32 ones: no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        S = comm.size if comm is not None else 1
        self.rank = comm.rank if comm is not None else 0
        # uniq_cap before the spec: its capacity is sized from it
        self.spec = make_exchange(g.num_nodes, S, ids_per_step=g.num_nodes,
                                  capacity_factor=capacity_factor)
        self.sharded = partition_edges(self.spec, g)
        self.spec = make_exchange(g.num_nodes, S,
                                  ids_per_step=self.sharded.uniq_cap,
                                  capacity_factor=capacity_factor)
        spec, sg, r = self.spec, self.sharded, self.rank
        rps = spec.rows_per_shard
        if mode == "halo":
            self.plan = plan_halo_exchange(spec, g, sg)
            hs, hi = self.plan.send_slot[r], self.plan.edge_vec_idx[r]
        else:
            self.plan = None
            hs, hi = np.zeros((S, 1), np.int32), np.zeros(1, np.int32)
        mine = slice(r * rps, (r + 1) * rps)

        def node(x, fill=0):
            return shard_node_array(spec, x, fill)[mine]

        def dev(x):
            return torch.as_tensor(np.ascontiguousarray(x),
                                   device=self.device)
        self._data = {
            "h0": dev(node(g.features)), "src": dev(sg.src[r]),
            "dst_local": dev(sg.dst_local[r]), "weight": dev(sg.weight[r]),
            "halo_send": dev(hs), "halo_idx": dev(hi),
            "labels": dev(node(g.labels)),
            "train": dev(node(g.train_mask.astype(np.float32))),
            "eval": dev(node(g.eval_mask.astype(np.float32)))}
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for w, b in init_gcn_params(cfg):
            self.weights.append(nn.Parameter(w.to(self.device)))
            self.biases.append(nn.Parameter(b.to(self.device)))

    @property
    def params(self) -> List[Tuple[nn.Parameter, nn.Parameter]]:
        """[(w, b)] per layer, JAX's `GCN.params` layout."""
        return list(zip(self.weights, self.biases))

    def load_params(self, params) -> "GCN":
        """Copy [(w, b)] per layer (tensors or arrays) into the layers."""
        with torch.no_grad():
            for (w, b), (pw, pb) in zip(params, self.params):
                pw.copy_(torch.as_tensor(w))
                pb.copy_(torch.as_tensor(b))
        return self

    def forward(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's (logits [rps, C], pull overflow) on its own nodes."""
        d = self._data
        S = self.spec.num_shards
        return gcn_forward(
            self.spec, self.params, d["h0"], d["src"], d["dst_local"],
            d["weight"], self.sharded.uniq_cap, self.mode,
            d["halo_send"].reshape(S, -1), d["halo_idx"], self.comm)

    def _sum(self, flat: torch.Tensor) -> torch.Tensor:
        """flat summed over the ranks (in place)."""
        return self.comm.all_reduce_(flat) if self.spec.num_shards > 1 \
            else flat

    def step(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """One SGD step, without waiting for the card: (loss [] f32,
        overflow [] int32), both summed over the ranks."""
        d = self._data
        cnt = self._sum(d["train"].sum().reshape(1))[0].clamp(min=1.0)
        params = list(self.parameters())
        with torch.enable_grad():
            logits, ovf = self.forward()
            logp = torch.log_softmax(logits, dim=1)
            ce = -logp.gather(1, d["labels"].long()[:, None])[:, 0]
            loss = (ce * d["train"]).sum() / cnt
            grads = torch.autograd.grad(loss, params)
        flat = self._sum(torch.cat([g.reshape(-1) for g in grads] + [
            loss.detach().reshape(1), ovf.to(torch.float32).reshape(1)]))
        with torch.no_grad():
            at = 0
            for p in params:
                p.sub_(self.cfg.learning_rate
                       * flat[at:at + p.numel()].view(p.shape))
                at += p.numel()
        return flat[-2], flat[-1].to(torch.int32)

    def train_step(self) -> Tuple[float, int]:
        loss, ovf = self.step()
        return float(loss), int(ovf)

    def fit(self, epochs: int = 50, verbose: bool = False) -> "GCN":
        for e in range(epochs):
            loss, ovf = self.train_step()
            if ovf:
                raise RuntimeError(
                    f"exchange overflow {ovf}: raise capacity_factor")
            if verbose and e % 10 == 0 and self.rank == 0:
                print(f"epoch {e}: loss {loss:.4f}")
        return self

    def accuracy(self, split: str = "eval") -> float:
        d = self._data
        mask = d["eval"] if split == "eval" else d["train"]
        with torch.no_grad():
            logits, _ = self.forward()
            hit = (logits.argmax(1) == d["labels"]).to(torch.float32) * mask
            c, t = self._sum(torch.stack([hit.sum(), mask.sum()])).tolist()
        return c / max(t, 1.0)

    def logits(self) -> np.ndarray:
        """[N, C] logical-order logits of every rank's nodes, on every rank
        (a collective over S > 1 ranks)."""
        with torch.no_grad():
            out, _ = self.forward()
            if self.spec.num_shards > 1:
                out = self.comm.all_gather(out).reshape(-1, out.shape[-1])
        return self.spec.to_logical(out.cpu().numpy())
