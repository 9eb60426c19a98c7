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
A table saved row-sharded over S devices is laid out strided
(parallel/exchange.py: logical row r at (r % S) * rps + r // S) and is
remapped to the port's single-device layout on load.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from herald_tpu_torch.bridge import tensor_from_numpy, tensor_to_numpy
from herald_tpu_torch.train.cached import CachedTrainState
from herald_tpu_torch.train.engine import TrainState

_BASE_LEAVES = ("table", "table_slots", "dense", "dense_slots", "step")
_CACHED_LEAVES = _BASE_LEAVES + ("cache", "hot_table", "hot_slots")


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


def save_checkpoint(state, path: str,
                    extras: Optional[Dict[str, Dict]] = None) -> None:
    """Single-process save in the JAX layout: every leaf replicated, one
    (empty) shard file. Writes <path>/v<step>/ and only then repoints
    <path>/LATEST, keeping the previous version; `extras` ({name:
    {key: array}}) become sidecar npz files in the same version dir."""
    version = f"v{int(state.step)}"
    vdir = os.path.join(path, version)
    os.makedirs(vdir, exist_ok=True)
    replicated: Dict[str, np.ndarray] = {}
    layout, shapes, dtypes = {}, {}, {}
    for key, leaf in _leaf_items(state):
        arr, name = tensor_to_numpy(leaf)
        replicated[key] = arr
        layout[key] = "replicated"
        shapes[key] = list(arr.shape)
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

    write_atomic("shards.p0.npz", savez({}))
    write_atomic("blocks.p0.json", dump_json([]))
    write_atomic("replicated.npz", savez(replicated))
    for name, arrs in (extras or {}).items():
        write_atomic(f"{name}.npz", savez(arrs))
    manifest = {"state_type": type(state).__name__, "num_processes": 1,
                "layout": layout, "shapes": shapes, "dtypes": dtypes}
    write_atomic("manifest.json", dump_json(manifest, indent=2))
    tmp = os.path.join(path, "LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(version)
    os.replace(tmp, os.path.join(path, "LATEST"))
    versions = sorted((d for d in os.listdir(path)
                       if d.startswith("v") and d[1:].isdigit()),
                      key=lambda d: int(d[1:]))
    for old in versions[:-2]:
        shutil.rmtree(os.path.join(path, old), ignore_errors=True)


class _BlockReader:
    """Assembles global index ranges of sharded leaves from saved blocks."""

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

    def num_row_blocks(self, key: str) -> int:
        return len({offs[0][0] for _, _, offs in self.meta.get(key, [])})

    def read(self, key: str, shape, dtype) -> np.ndarray:
        out = np.empty(shape, dtype)
        filled = 0
        for p, fk, offs in self.meta.get(key, []):
            if p not in self._npz:
                self._npz[p] = np.load(
                    os.path.join(self.path, f"shards.p{p}.npz"))
            data = self._npz[p][fk]
            out[tuple(slice(s, e) for s, e in offs)] = data
            filled += int(np.prod([e - s for s, e in offs]))
        if filled < out.size:
            raise ValueError(
                f"checkpoint blocks do not cover leaf {key!r} "
                f"(covered {filled} of {out.size})")
        return out


def _remap_rows(full_src: np.ndarray, s_src: int, rows: int) -> np.ndarray:
    """A strided-layout row leaf saved over `s_src` shards, laid out for
    one device with `rows` rows (`herald_tpu/train/checkpoint.py:220`)."""
    rps_src = full_src.shape[0] // s_src
    r = np.arange(rows)                                # logical ids
    p_src = (r % s_src) * rps_src + r // s_src         # source physical
    valid = r < s_src * rps_src
    out = np.zeros((rows,) + full_src.shape[1:], full_src.dtype)
    out[valid] = full_src[p_src[valid]]
    return out


def _insert(tree: Dict, parts: List[str], value) -> None:
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def _read_leaves(path: str, device, padded_rows: Optional[int],
                 wanted: Tuple[str, ...]) -> Tuple[Dict, Dict]:
    """(manifest, field trees) of the leaves whose first path part is in
    `wanted`, read onto `device`."""
    path = _version_dir(path)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    repl_path = os.path.join(path, "replicated.npz")
    if not os.path.exists(repl_path):
        raise FileNotFoundError(
            f"checkpoint {path!r} has a manifest but no replicated.npz — "
            f"multi-host checkpoints must live on storage shared by every "
            f"process")
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
                shape = tuple(manifest["shapes"][key])
                if where == "sharded":
                    arr = reader.read(key, shape, _storage_dtype(name))
                    s_src = reader.num_row_blocks(key)
                else:
                    arr = repl[key]
                    s_src = 1
                if (padded_rows is not None
                        and parts[0] in ("table", "table_slots")
                        and (s_src != 1 or shape[0] != padded_rows)):
                    arr = _remap_rows(arr, s_src, padded_rows)
                _insert(fields, parts, tensor_from_numpy(arr, name, device))
    finally:
        reader.close()
    # a slotless dense optimizer saves no dense_slots leaves; its tree is
    # {"W1": {}, ...}, as the engine builds it and JAX keeps it
    for k in fields["dense"]:
        fields["dense_slots"].setdefault(k, {})
    return manifest, fields


def load_checkpoint(path: str, device, padded_rows: Optional[int] = None
                    ) -> TrainState:
    """Read the base leaves of a TrainState or CachedTrainState
    checkpoint (written by either package) onto `device`. With
    `padded_rows`, table leaves saved under another shard count or row
    padding are remapped to one device's layout of that many rows."""
    _, fields = _read_leaves(path, device, padded_rows, _BASE_LEAVES)
    del fields["hot_slots"]
    return TrainState(**fields)


def load_cached_checkpoint(path: str, device) -> CachedTrainState:
    """Read a whole single-device CachedTrainState checkpoint (written by
    either package, e.g. mid-stream) onto `device`. The cache arrays
    belong to the planner stream that wrote them, so the layout must be
    the training run's own: nothing is remapped."""
    manifest, fields = _read_leaves(path, device, None, _CACHED_LEAVES)
    if manifest["state_type"] != "CachedTrainState":
        raise ValueError(f"checkpoint {path!r} holds a "
                         f"{manifest['state_type']}, not a "
                         f"CachedTrainState")
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
