"""Megatron-style tensor-parallel layer helpers (port of
`herald_tpu/parallel/tp.py`).

The tower's weights arrive column- or row-sharded over the mp group (a
`Comm` of `parallel/comm.py`, `Comm.grid`), and each helper inserts the
one collective its layer kind needs:

- column-parallel W [K, N/mp]: output features sharded, no collective;
- row-parallel    W [K/mp, N]: input features sharded, a sum after;
- replicated      W: the whole of it on every rank.

The backward of each collective is the transpose JAX's autodiff takes
under `shard_map(check_vma=False)`, not the textbook Megatron pairing:

| forward | backward |
|---|---|
| sum over the group (`lax.psum`) | sum over the group |
| tiled all-gather | reduce-scatter, this rank's block |
| this rank's slice (`row_parallel`, `my_batch_chunk`) | zero elsewhere |

That is right only because each mp peer's loss covers its own batch
chunk and nothing else (`herald_tpu/train/engine.py:370-385`): the
peers' cotangents are disjoint, so a sum of them counts each sample
once. `train/engine.py` keeps that rule. With a `comm` of one rank (or
None) each helper returns its input.

The layout of a tower over the group, for the engine, checkpoints and
`bridge.py`: a model's `tp_plan` names each sharded param's kind, and
`shard_axis`, `shard_bounds`, `cut` and `join` say where shard j of mp
lies in the global param.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


def plan_kind(tp_plan, name: str) -> str:
    """"col", "row" or "rep": how param `name` lies under `tp_plan`."""
    return (tp_plan or {}).get(name, "rep")


def shard_axis(kind: str, ndim: int) -> Optional[int]:
    """The axis a param of kind `kind` is cut along over the mp group: a
    "col" param's last (its output features), a "row" param's first (its
    input features); None for a replicated one."""
    return {"col": ndim - 1, "row": 0}.get(kind)


def shard_bounds(kind: str, shape, mp: int,
                 j: int) -> Optional[List[List[int]]]:
    """[[lo, hi], ...] of shard j of mp of a param of global `shape` on
    each axis, or None for a replicated param."""
    ax = shard_axis(kind, len(shape))
    if ax is None:
        return None
    b = [[0, d] for d in shape]
    n = shape[ax] // mp
    b[ax] = [j * n, (j + 1) * n]
    return b


def cut(tree, tp_plan, mp: int, j: int):
    """Shard j of mp of each param of a dense dict ({name: array}) or of a
    dense-slot dict ({name: {slot: array}}), numpy or torch: the columns
    of a "col" param, the rows of a "row" one, the whole of the rest."""
    def one(name, a):
        if isinstance(a, dict):
            return {k: one(name, v) for k, v in a.items()}
        b = shard_bounds(plan_kind(tp_plan, name), a.shape, mp, j)
        return a if b is None else a[tuple(slice(*x) for x in b)]
    return {k: one(k, v) for k, v in tree.items()}


def join(trees, tp_plan):
    """The inverse of `cut`: the mp shards' dicts (in mp order) of host
    arrays joined into the global one; a replicated param is shard 0's."""
    def one(name, xs):
        if isinstance(xs[0], dict):
            return {k: one(name, [x[k] for x in xs]) for k in xs[0]}
        ax = shard_axis(plan_kind(tp_plan, name), xs[0].ndim)
        return xs[0] if ax is None else np.concatenate(xs, ax)
    return {k: one(k, [t[k] for t in trees]) for k in trees[0]}


def _one(comm) -> bool:
    return comm is None or comm.size == 1


class _Sum(torch.autograd.Function):
    """Sum over the group; its backward sums the gradient over the group
    (JAX's transpose of `psum` without replication checks)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce_(g.contiguous().clone()), None


class _Gather(torch.autograd.Function):
    """Tiled all-gather along `dim`; its backward is the reduce-scatter
    along `dim` that keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.reduce_scatter(g, ctx.dim), None, None


def psum(x: torch.Tensor, comm) -> torch.Tensor:
    """x summed over the group, as JAX's `lax.psum` under autodiff."""
    return x if _one(comm) else _Sum.apply(x, comm)


def all_gather(x: torch.Tensor, comm, dim: int) -> torch.Tensor:
    """The ranks' x joined along `dim`, as JAX's tiled `all_gather`."""
    return x if _one(comm) else _Gather.apply(x, comm, dim % x.dim())


def row_parallel(x_full: torch.Tensor, w_shard: torch.Tensor,
                 comm) -> torch.Tensor:
    """Row-parallel matmul of a FULL activation: each peer multiplies its
    column chunk of `x_full` by its row shard of W, then the sum.
    x_full [..., K] (the same on every peer); w_shard [K/mp, N]."""
    if _one(comm):
        return x_full @ w_shard
    k = w_shard.shape[0]
    xs = x_full[..., comm.rank * k:(comm.rank + 1) * k]
    return psum(xs @ w_shard, comm)


def row_parallel_sharded(x_shard: torch.Tensor, w_shard: torch.Tensor,
                         comm) -> torch.Tensor:
    """Row-parallel matmul of a column-sharded activation (the Megatron
    pair after a column-parallel layer): [..., K/mp] @ [K/mp, N], summed
    to the full [..., N]."""
    return psum(x_shard @ w_shard, comm)


def gather_cols(x_shard: torch.Tensor, comm) -> torch.Tensor:
    """The full activation from a column-sharded one ([..., N/mp] ->
    [..., N])."""
    return all_gather(x_shard, comm, -1)


def gather_batch(x_shard: torch.Tensor, comm) -> torch.Tensor:
    """The mp group's batches joined ([B, ...] -> [B*mp, ...]), to feed
    one tower the samples of all its peers; the backward hands each peer
    the summed gradient of its own chunk."""
    return all_gather(x_shard, comm, 0)


def my_batch_chunk(x_full: torch.Tensor, per_device: int,
                   comm) -> torch.Tensor:
    """This peer's batch chunk of a group-batch result."""
    if _one(comm):
        return x_full
    return x_full[comm.rank * per_device:(comm.rank + 1) * per_device]
