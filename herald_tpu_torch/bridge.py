"""Numpy <-> torch conversion of engine state.

`state_from_numpy` turns the JAX package's state, as numpy arrays
(e.g. `jax.tree.map(np.asarray, state)`), into the port's `TrainState`,
its `CachedTrainState` when the leaves carry the cache arrays, or its
`FaeTrainState` when they carry a hot block and no cache;
`state_to_numpy` goes the other way, to a state of host arrays in the
same NamedTuple type. `shard_state` takes JAX's hybrid state, a
`TrainState`, `FaeTrainState` or `CachedTrainState` (the physical,
row-sharded table and its slots; the replicated tower and hot block; the
cached state's row-sharded cache and hot slots) to one rank's state, its
block of each sharded leaf, and `join_states` takes the ranks' states
back to the global one (`ExchangeSpec.to_logical` then gives the logical
table). Given a model's `tp_plan` and mp > 1, `shard_state` also cuts
the tower (JAX's global dense params and slots) to rank r's shards: the
ranks form a (S / mp, mp) grid, rank r holds shard r % mp of each col
(columns) or row (rows) param, and `join_states` joins the shards of
ranks 0..mp-1 back (`parallel/tp.py`'s `cut` and `join`).
`gcn_params_from_jax` takes the JAX GCN's `[(w, b), ...]` to the port's
(`gnn.GCN.load_params` copies them into a model).
bfloat16 has no numpy dtype without `ml_dtypes`, and `np.savez` stores it
as raw 2-byte voids (`|V2`), so bf16 leaves cross as their 16-bit
patterns: a `uint16`/`int16`/`V2` view reinterpreted as `torch.bfloat16`.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Tuple, Union

import numpy as np
import torch

from herald_tpu_torch.parallel import tp
from herald_tpu_torch.train.engine import TrainState

if TYPE_CHECKING:
    from herald_tpu_torch.train.cached import CachedTrainState
    from herald_tpu_torch.train.fae import FaeTrainState

# the states of the row-sharded engines
HybridState = Union[TrainState, "FaeTrainState", "CachedTrainState"]


def tensor_from_numpy(a: np.ndarray, dtype_name: Optional[str] = None,
                      device="cpu") -> torch.Tensor:
    """A numpy array as a tensor on `device`. `dtype_name` (a checkpoint
    manifest's dtype string) overrides the array's own dtype, which for a
    bf16 leaf read without `ml_dtypes` is only `V2`."""
    a = np.asarray(a)
    name = dtype_name or a.dtype.name
    if name == "bfloat16":
        if a.dtype.itemsize != 2:
            raise ValueError(f"bfloat16 leaf stored as {a.dtype}")
        a = a.view(np.int16)
        bf16 = True
    elif a.dtype.kind == "V":
        raise ValueError(f"raw {a.dtype} leaf without a dtype name")
    else:
        bf16 = False
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a, order="C")
    t = torch.from_numpy(a)
    if bf16:
        t = t.view(torch.bfloat16)
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(host array, dtype name). A bf16 tensor becomes a `V2` array of its
    bit patterns: the layout `np.savez` gives a JAX bf16 leaf."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
    a = t.numpy()
    return a, a.dtype.name


def state_from_numpy(leaves, device):
    """A TrainState-, CachedTrainState- or FaeTrainState-shaped object of
    numpy arrays (fields table, table_slots, dense, dense_slots, step; for
    the cached state cache, hot_table, hot_slots; for the FAE state
    hot_table, hot_slots) -> the port's state of the same kind. The trees
    keep JAX's shape: a slotless optimizer's dense slots stay
    `{"W1": {}, ...}`."""
    def conv(a):
        return tensor_from_numpy(a, device=device)
    base = TrainState(
        table=conv(leaves.table),
        table_slots={k: conv(v) for k, v in leaves.table_slots.items()},
        dense={k: conv(v) for k, v in leaves.dense.items()},
        dense_slots={k: {s: conv(x) for s, x in v.items()}
                     for k, v in leaves.dense_slots.items()},
        step=conv(leaves.step))
    if not hasattr(leaves, "hot_table"):
        return base
    hot = {"hot_table": conv(leaves.hot_table),
           "hot_slots": {k: conv(v) for k, v in leaves.hot_slots.items()}}
    if not hasattr(leaves, "cache"):
        from herald_tpu_torch.train.fae import FaeTrainState
        return FaeTrainState(*base, **hot)
    from herald_tpu_torch.train.cached import CachedTrainState
    return CachedTrainState(*base, cache=conv(leaves.cache), **hot)


def state_to_numpy(state):
    """The port's TrainState, CachedTrainState or FaeTrainState with every
    tensor as a host array (bf16 as its `V2` bit patterns;
    `tensor_to_numpy`), in the same NamedTuple type and trees."""
    def conv(t):
        return tensor_to_numpy(t)[0]

    def tree(x):
        if isinstance(x, dict):
            return {k: tree(v) for k, v in x.items()}
        return conv(x)
    return type(state)(*(tree(f) for f in state))


def _sharded_fields(state) -> tuple:
    """The row-sharded fields of a hybrid state: the table and its slots,
    and a cached state's cache and hot slots."""
    return ("table", "table_slots") + (
        ("cache", "hot_slots") if hasattr(state, "cache") else ())


def shard_state(leaves, spec, rank: int, device, tp_plan=None,
                mp: int = 1) -> HybridState:
    """JAX's hybrid TrainState, FaeTrainState or CachedTrainState of numpy
    arrays (table and slots [S * rows_per_shard, W] in the physical layout
    of `spec`, an `ExchangeSpec` of `parallel/exchange.py`; a cached
    state's cache [S * C, 2W] and hot slots [P, W], 1 row a rank with no
    pinned tier) -> rank `rank`'s state of the same kind: block `rank` of
    S equal blocks of rows of each sharded leaf, and the whole of every
    replicated leaf (the tower; the hot block, and the FAE state's hot
    slots). With `tp_plan` and mp > 1 the tower and its slots are cut to
    the rank's shards (`parallel/tp.py` `cut`, shard rank % mp)."""
    def block(x):
        if isinstance(x, dict):
            return {k: block(v) for k, v in x.items()}
        n = len(x) // spec.num_shards
        return x[rank * n:(rank + 1) * n]
    d = leaves._asdict()
    for f in _sharded_fields(leaves):
        d[f] = block(d[f])
    if mp > 1:
        for f in ("dense", "dense_slots"):
            d[f] = tp.cut(d[f], tp_plan, mp, rank % mp)
    return state_from_numpy(type(leaves)(**d), device)


def join_states(rank_leaves, tp_plan=None, mp: int = 1) -> HybridState:
    """The ranks' states as host arrays (`state_to_numpy` of each, in rank
    order; TrainState, FaeTrainState or CachedTrainState) -> one state of
    the same kind: each rank's block of every sharded leaf one after the
    other (the table, its slots, and a cached state's cache and hot
    slots), and rank 0's copy of every replicated leaf (the tower; the
    hot block, and the FAE state's hot slots)."""
    def cat(xs):
        if isinstance(xs[0], dict):
            return {k: cat([x[k] for x in xs]) for k in xs[0]}
        return np.concatenate(xs)
    first = rank_leaves[0]
    out = first._replace(**{f: cat([getattr(r, f) for r in rank_leaves])
                            for f in _sharded_fields(first)})
    if mp > 1:
        out = out._replace(**{f: tp.join([getattr(r, f)
                                          for r in rank_leaves[:mp]],
                                         tp_plan)
                              for f in ("dense", "dense_slots")})
    return out


def gcn_params_from_jax(params) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The JAX GCN's parameters `[(w, b), ...]` (arrays of any kind that
    numpy reads) as the port's: `[(w, b), ...]` f32 CPU tensors, for
    `gnn.GCN.load_params`."""
    return [(torch.from_numpy(np.array(w, np.float32)),
             torch.from_numpy(np.array(b, np.float32)))
            for w, b in params]
