"""Checkpoints in the JAX package's on-disk layout
(`herald_tpu/train/checkpoint.py:11-27`), so a checkpoint moves between
the two packages in either direction.

Layout under <path>/ (each save in <path>/v<step>/, named by <path>/LATEST):
    manifest.json      state type, leaf shapes/dtypes/layout, process count
    replicated.npz     fully-replicated leaves (process 0)
    shards.p<i>.npz    process i's blocks of sharded leaves (keys b0, b1, ...)
    blocks.p<i>.json   block metadata: leaf key + global offsets per block

Leaf keys are the JAX pytree paths joined with "/": "table",
"table_slots/<slot>", "dense/W1", "dense_slots/W1/<slot>", "step", and
for a CachedTrainState also "cache", "hot_table", "hot_slots/<slot>".
`load_checkpoint` reads the five base leaves of either state type (the
JAX `to_base_state` view); `load_cached_checkpoint` reads a whole
CachedTrainState, e.g. to resume a scheduled run mid-stream.

Over S ranks (a `Comm` of `parallel/comm.py`) rank r writes its block of
every row-sharded leaf (the table and its slots; a cached state's cache
and hot slots: `bridge._sharded_fields`) into shards.p<r>.npz with its
global offsets, rank 0 writes the rest, and LATEST moves after a barrier,
once every shard file exists; JAX's process p writes the blocks of its
devices the same way. A restore reads only the blocks that cover the
rank's own rows. A table saved over another shard count is laid out
strided (parallel/exchange.py: logical row r at (r % S) * rps + r // S)
and is remapped to the target's layout on load; the cache arrays belong
to the planner stream that wrote them and restore at the same S only.

A state of the tensor-parallel tower (`tp=(tp_plan, mp)`, mp > 1) saves
each col or row param and its slots as a sharded leaf of its global
shape: ranks 0..mp-1 (the first dp row, JAX's replica 0) each write
their shard as one block with its bounds, as JAX's process writes the
blocks of an mp-sharded leaf (`herald_tpu/train/checkpoint.py:45-160`).
A restore with `tp` reads the rank's shard of such a leaf, from blocks
or from a replicated leaf; without it the whole leaf, joined from its
blocks. So a checkpoint moves between mp = 1 and mp > 1 at one S, in
either package.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from herald_tpu_torch.bridge import (_sharded_fields, tensor_from_numpy,
                                     tensor_to_numpy)
from herald_tpu_torch.parallel.tp import plan_kind, shard_axis, shard_bounds
from herald_tpu_torch.train.cached import CachedTrainState
from herald_tpu_torch.train.engine import TrainState

_BASE_LEAVES = ("table", "table_slots", "dense", "dense_slots", "step")
_CACHED_LEAVES = _BASE_LEAVES + ("cache", "hot_table", "hot_slots")
# the leaves row-sharded over S ranks (`bridge._sharded_fields`)
_ROW_FIELDS = ("table", "table_slots", "cache", "hot_slots")


def _version_dir(path: str) -> str:
    latest = os.path.join(path, "LATEST")
    if os.path.exists(latest):
        with open(latest) as f:
            return os.path.join(path, f.read().strip())
    return path


def read_manifest(path: str) -> Dict:
    with open(os.path.join(_version_dir(path), "manifest.json")) as f:
        return json.load(f)


def _storage_dtype(name: str) -> np.dtype:
    """The numpy dtype a leaf is stored as: bf16 leaves are raw `V2`."""
    return np.dtype("V2") if name == "bfloat16" else np.dtype(name)


def _leaf_items(state) -> List[Tuple[str, torch.Tensor]]:
    items = [("table", state.table)]
    items += [(f"table_slots/{k}", v)
              for k, v in sorted(state.table_slots.items())]
    items += [(f"dense/{k}", v) for k, v in sorted(state.dense.items())]
    items += [(f"dense_slots/{k}/{s}", x)
              for k, v in sorted(state.dense_slots.items())
              for s, x in sorted(v.items())]
    items.append(("step", state.step))
    if isinstance(state, CachedTrainState):
        items += [("cache", state.cache), ("hot_table", state.hot_table)]
        items += [(f"hot_slots/{k}", v)
                  for k, v in sorted(state.hot_slots.items())]
    return items


def _rank_size(comm) -> Tuple[int, int]:
    return (comm.rank, comm.size) if comm is not None else (0, 1)


def _tp_bounds(key: str, shape, tp, j: int):
    """The global bounds of shard j of a dense leaf `key` ("dense/<k>" or
    "dense_slots/<k>/<slot>") of global `shape` under `tp` = (tp_plan,
    mp), or None when the leaf is replicated."""
    parts = key.split("/")
    if tp is None or parts[0] not in ("dense", "dense_slots"):
        return None
    return shard_bounds(plan_kind(tp[0], parts[1]), shape, tp[1], j)


def save_checkpoint(state, path: str,
                    extras: Optional[Dict[str, Dict]] = None,
                    comm=None, tp=None) -> None:
    """Save in the JAX layout into <path>/v<step>/, then repoint
    <path>/LATEST, keeping the previous version; `extras` ({name: {key:
    array}}) become sidecar npz files in the same version dir. On one
    process every leaf is replicated and the shard file is empty. Over
    the S > 1 ranks of `comm` every rank must call it: each writes its
    own blocks of the row-sharded leaves, rank 0 the replicated ones (its
    tower), the extras and the manifest, and rank 0 moves LATEST only
    after a barrier that every rank enters once its files are written;
    a second barrier holds every rank until LATEST has moved. With `tp`
    = (tp_plan, mp) the state's col and row tower params are this rank's
    shards, saved as blocks by ranks 0..mp-1."""
    rank, S = _rank_size(comm)
    sharded = _sharded_fields(state) if S > 1 else ()
    version = f"v{int(state.step)}"
    vdir = os.path.join(path, version)
    os.makedirs(vdir, exist_ok=True)
    blocks: Dict[str, np.ndarray] = {}
    block_meta, replicated = [], {}
    layout, shapes, dtypes = {}, {}, {}
    for key, leaf in _leaf_items(state):
        if key.split("/")[0] in sharded:
            # block `rank` of S equal blocks of the global leaf, by rows
            arr, name = tensor_to_numpy(leaf)
            n = arr.shape[0]
            fk = f"b{len(block_meta)}"
            blocks[fk] = arr
            block_meta.append({"key": key, "file_key": fk, "offsets": [
                [rank * n, (rank + 1) * n]] + [[0, d] for d in arr.shape[1:]]})
            layout[key] = "sharded"
            shapes[key] = [S * n] + list(arr.shape[1:])
        elif _tp_bounds(key, leaf.shape, tp, 0) is not None:
            # a tower shard, written by the first dp row as one block of
            # the global leaf
            plan, mp = tp
            if rank >= mp:
                continue
            shape = list(leaf.shape)
            shape[shard_axis(plan_kind(plan, key.split("/")[1]),
                             len(shape))] *= mp
            arr, name = tensor_to_numpy(leaf)
            fk = f"b{len(block_meta)}"
            blocks[fk] = arr
            block_meta.append({"key": key, "file_key": fk,
                               "offsets": _tp_bounds(key, shape, tp, rank)})
            layout[key], shapes[key] = "sharded", shape
        elif rank == 0:
            arr, name = tensor_to_numpy(leaf)
            replicated[key] = arr
            layout[key] = "replicated"
            shapes[key] = list(arr.shape)
        else:
            continue      # rank 0 writes the replicated leaves
        dtypes[key] = name

    def write_atomic(name, writer):
        tmp = os.path.join(vdir, name + ".tmp")
        writer(tmp)
        os.replace(tmp, os.path.join(vdir, name))

    def savez(arrays):
        def writer(tmp):
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
        return writer

    def dump_json(obj, **kw):
        def writer(tmp):
            with open(tmp, "w") as f:
                json.dump(obj, f, **kw)
        return writer

    write_atomic(f"shards.p{rank}.npz", savez(blocks))
    write_atomic(f"blocks.p{rank}.json", dump_json(block_meta))
    if rank == 0:
        write_atomic("replicated.npz", savez(replicated))
        for name, arrs in (extras or {}).items():
            write_atomic(f"{name}.npz", savez(arrs))
        manifest = {"state_type": type(state).__name__, "num_processes": S,
                    "layout": layout, "shapes": shapes, "dtypes": dtypes}
        write_atomic("manifest.json", dump_json(manifest, indent=2))
    if S > 1:
        # every shard file exists before LATEST names the version
        comm.barrier()
    if rank == 0:
        tmp = os.path.join(path, "LATEST.tmp")
        with open(tmp, "w") as f:
            f.write(version)
        os.replace(tmp, os.path.join(path, "LATEST"))
        versions = sorted((d for d in os.listdir(path)
                           if d.startswith("v") and d[1:].isdigit()),
                          key=lambda d: int(d[1:]))
        for old in versions[:-2]:
            shutil.rmtree(os.path.join(path, old), ignore_errors=True)
    if S > 1:
        # and no rank returns before LATEST names it
        comm.barrier()


class _BlockReader:
    """Assembles global index ranges of sharded leaves from saved blocks:
    one file per process, each holding one block per device that process
    saved (the port's ranks save one each; JAX's one process over S
    devices saves S)."""

    def __init__(self, path: str, num_processes: int):
        self.path = path
        self.meta: Dict[str, list] = {}
        self._npz: Dict[int, "np.lib.npyio.NpzFile"] = {}
        for p in range(num_processes):
            with open(os.path.join(path, f"blocks.p{p}.json")) as f:
                for m in json.load(f):
                    self.meta.setdefault(m["key"], []).append(
                        (p, m["file_key"],
                         [tuple(x) for x in m["offsets"]]))

    def close(self):
        for z in self._npz.values():
            z.close()
        self._npz = {}

    def num_row_blocks(self, key: str) -> int:
        return len({offs[0][0] for _, _, offs in self.meta.get(key, [])})

    def read(self, key: str, bounds: List[Tuple[int, int]],
             dtype) -> np.ndarray:
        """The global range `bounds` ([(start, stop)] a dimension) of leaf
        `key`, filled from the blocks that intersect it; only those are
        read. Raises when the blocks do not cover the range."""
        bounds = [tuple(b) for b in bounds]
        out, filled = None, 0
        for p, fk, offs in self.meta.get(key, []):
            inter = [(max(ts, bs), min(te, be))
                     for (ts, te), (bs, be) in zip(bounds, offs)]
            if any(s >= e for s, e in inter):
                continue
            if p not in self._npz:
                self._npz[p] = np.load(
                    os.path.join(self.path, f"shards.p{p}.npz"))
            data = self._npz[p][fk]
            if list(offs) == bounds:
                return data          # one block is the whole range
            if out is None:
                out = np.empty([e - s for s, e in bounds], dtype)
            out[tuple(slice(s - ts, e - ts)
                      for (s, e), (ts, _) in zip(inter, bounds))] = \
                data[tuple(slice(s - bs, e - bs)
                           for (s, e), (bs, _) in zip(inter, offs))]
            filled += int(np.prod([e - s for s, e in inter]))
        size = int(np.prod([e - s for s, e in bounds]))
        if filled < size:
            raise ValueError(
                f"checkpoint blocks do not cover leaf {key!r} range "
                f"{bounds} (covered {filled} of {size})")
        return out


def _remap_rows(full_src: np.ndarray, s_src: int, rows: int, s_dst: int,
                rank: int) -> np.ndarray:
    """Block `rank` of a strided-layout row leaf saved over `s_src`
    shards, laid out for `s_dst` shards of `rows` rows in all
    (`herald_tpu/train/checkpoint.py:220`): local slot q holds logical row
    q * s_dst + rank, read from its slot in the source layout."""
    rps_src = full_src.shape[0] // s_src
    r = np.arange(rows // s_dst) * s_dst + rank        # logical ids
    p_src = (r % s_src) * rps_src + r // s_src         # source physical
    valid = r < s_src * rps_src
    out = np.zeros((len(r),) + full_src.shape[1:], full_src.dtype)
    out[valid] = full_src[p_src[valid]]
    return out


def _insert(tree: Dict, parts: List[str], value) -> None:
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def _read_leaves(path: str, device, padded_rows: Optional[int],
                 wanted: Tuple[str, ...], comm=None,
                 tp=None) -> Tuple[Dict, Dict]:
    """(manifest, field trees) of the leaves whose first path part is in
    `wanted`, read onto `device`: the whole of every replicated leaf, and
    over the S ranks of `comm` rank r's block of every row-sharded one.
    With `padded_rows` the table leaves are laid out for S blocks of that
    many rows in all, remapped from any saved layout; without it they,
    like the cache and hot slots, need the saved shard count (at S = 1
    the table then reads as saved). With `tp` = (tp_plan, mp) each col or
    row tower leaf reads as this rank's shard (shard rank % mp)."""
    rank, S = _rank_size(comm)
    path = _version_dir(path)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    repl_path = os.path.join(path, "replicated.npz")
    if not os.path.exists(repl_path):
        raise FileNotFoundError(
            f"checkpoint {path!r} has a manifest but no replicated.npz — "
            f"multi-host checkpoints must live on storage shared by every "
            f"process (each process writes its own shard blocks and the "
            f"leader writes replicated.npz; all must be readable here)")
    reader = _BlockReader(path, int(manifest["num_processes"]))
    fields: Dict = {"table_slots": {}, "dense": {}, "dense_slots": {},
                    "hot_slots": {}}
    try:
        with np.load(repl_path) as repl:
            for key, where in manifest["layout"].items():
                parts = key.split("/")
                if parts[0] not in wanted:
                    continue
                name = manifest["dtypes"][key]
                dtype = _storage_dtype(name)
                shape = tuple(manifest["shapes"][key])
                saved_sharded = where == "sharded"
                s_src = reader.num_row_blocks(key) if saved_sharded else 1

                def rows(lo, hi):
                    if saved_sharded:
                        return reader.read(key, [(lo, hi)] + [
                            (0, d) for d in shape[1:]], dtype)
                    return repl[key][lo:hi]
                tb = _tp_bounds(key, shape, tp, rank % tp[1]) if tp \
                    else None
                if tb is not None:
                    arr = reader.read(key, tb, dtype) if saved_sharded \
                        else repl[key][tuple(slice(a, b) for a, b in tb)]
                elif parts[0] in ("table", "table_slots") \
                        and padded_rows is not None \
                        and (s_src != S or shape[0] != padded_rows):
                    # a resize: the source's logical rows, laid out anew
                    arr = _remap_rows(rows(0, shape[0]), s_src, padded_rows,
                                      S, rank)
                elif parts[0] in _ROW_FIELDS and s_src != S and (
                        S > 1 or parts[0] in ("cache", "hot_slots")):
                    raise ValueError(
                        f"leaf {key!r} cannot restore across topologies "
                        f"({s_src} -> {S} shards); for cached states, "
                        f"sync_cache and checkpoint a plain TrainState "
                        f"before resizing the pod")
                elif parts[0] in _ROW_FIELDS and S > 1:
                    n = shape[0] // S           # this rank's block only
                    arr = rows(rank * n, (rank + 1) * n)
                else:
                    arr = rows(0, shape[0]) if shape else repl[key]
                _insert(fields, parts, tensor_from_numpy(arr, name, device))
    finally:
        reader.close()
    if S > 1:
        # no rank may prune a version (a later save) another still reads
        comm.barrier()
    # a slotless dense optimizer saves no dense_slots leaves; its tree is
    # {"W1": {}, ...}, as the engine builds it and JAX keeps it
    for k in fields["dense"]:
        fields["dense_slots"].setdefault(k, {})
    return manifest, fields


def load_checkpoint(path: str, device, padded_rows: Optional[int] = None,
                    comm=None, tp=None) -> TrainState:
    """Read the base leaves of a TrainState or CachedTrainState
    checkpoint (written by either package, over any number of processes
    and shards) onto `device`. With `padded_rows`, table leaves saved
    under another shard count or row padding are remapped to one
    device's layout of that many rows, or over the S > 1 ranks of
    `comm` (every rank calls it) to rank r's block of S blocks of
    `padded_rows` rows in all; at the saved S a rank reads only the
    blocks that cover its own rows. With `tp` = (tp_plan, mp) the tower's
    col and row params and slots read as this rank's shards."""
    _, fields = _read_leaves(path, device, padded_rows, _BASE_LEAVES, comm,
                             tp)
    del fields["hot_slots"]
    return TrainState(**fields)


def load_cached_checkpoint(path: str, device, comm=None
                           ) -> CachedTrainState:
    """Read a whole CachedTrainState checkpoint (written by either
    package, e.g. mid-stream) onto `device`, or over the ranks of `comm`
    (every rank calls it) rank r's block of each row-sharded leaf. The
    cache arrays belong to the planner stream that wrote them, so the
    shard count must be the training run's own: nothing is remapped, and
    a checkpoint of another shard count raises."""
    manifest = read_manifest(path)
    if manifest["state_type"] != "CachedTrainState":
        raise ValueError(f"checkpoint {path!r} holds a "
                         f"{manifest['state_type']}, not a "
                         f"CachedTrainState")
    _, fields = _read_leaves(path, device, None, _CACHED_LEAVES, comm)
    return CachedTrainState(**fields)


def load_extra(path: str, name: str) -> Optional[Dict[str, np.ndarray]]:
    """A sidecar npz written via save_checkpoint(extras=...), or None."""
    f = os.path.join(_version_dir(path), f"{name}.npz")
    if not os.path.exists(f):
        return None
    with np.load(f) as z:
        return {k: z[k] for k in z.files}


def apply_serve_overlay(state: TrainState, overlay: Dict) -> TrainState:
    """Patch a base-view TrainState with a serve overlay (the JAX
    `CachedEngine.serve_overlay`): the synced values of the rows whose
    deltas were still in the cache at save time, plus the pinned hot
    block. Writes into the state's tensors in place; row indices outside
    the table are dropped, as the JAX `mode="drop"` scatter does."""
    table = state.table
    R = table.shape[0]

    def patch(arr, idx, vals):
        idx = np.asarray(idx, np.int64)
        keep = (idx >= 0) & (idx < R)
        vals = np.asarray(vals)
        # a bf16 sidecar array reads back as raw V2 bit patterns
        v = tensor_from_numpy(vals[keep], "bfloat16"
                              if vals.dtype.kind == "V" else None,
                              arr.device)
        arr[torch.as_tensor(idx[keep], device=arr.device)] = v.to(arr.dtype)

    rows = overlay["rows"]
    if len(rows):
        patch(table, rows, overlay["values"])
        for k, slot in state.table_slots.items():
            sk = overlay.get(f"slot/{k}")
            if sk is not None:
                patch(slot, rows, sk)
    hot_rows = overlay.get("hot_rows")
    if hot_rows is not None and len(hot_rows):
        patch(table, hot_rows, overlay["hot_values"])
    return state
