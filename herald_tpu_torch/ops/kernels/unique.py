"""`unique_fill`: JAX's `jnp.unique(ids, size=size, fill_value=fill,
return_inverse=True)` for int32 ids on the card, in one launch.

No Pallas counterpart: the JAX package's steps call `jnp.unique`, which
XLA lowers to a sort and scans. The plain version, `unique_fill_ref`, is
the library chain the port ran before: a sort, the flags of each new id,
their running count and two scatters, about a dozen launches inside a step's
graph for the 26 KB of a wdl step's 6,656 ids. The kernel
(`csrc/unique_fill.cu`) does the same in one launch of a cluster of blocks:
the distinct ids in eight parts by value, one block each, a hash table
and a bitonic sort in each block's shared memory. The outputs are fixed by
the maths, so the two agree bit for bit.

Bound on the card: latency. The bytes (ids read once, uniq and inv written
once) take under 0.1 us; the chain of block-wide steps sets the time, and
the eight blocks each take a part of the ids to keep it short.

The kernel takes at most `CAPACITY` ids. `fits` is the rule the dedup
(`ops/embedding.py` `unique_fill`) reads to choose between the two: int32
ids on a card, at most `CAPACITY` of them. `unique_fill` launches the
kernel for ids on the card, takes the plain version only for ids on the
CPU, and raises on ids the kernel does not take. The wrapper allocates the
two outputs and nothing else, and waits for nothing, so the launch is
captured into a step's graph.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from herald_tpu_torch.ops.kernels import build

CAPACITY = 8192         # ids one launch takes (kCapacity in the .cu)
_INT32 = torch.iinfo(torch.int32)


def unique_fill_ref(ids: torch.Tensor, size: int, fill: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: one sort, the flags of each new id, their
    running count and two scatters (a slot's duplicates all write its one
    id). Every shape is fixed, so nothing waits for the card."""
    flat = ids.reshape(-1)
    n = flat.numel()
    srt, order = torch.sort(flat)
    new = torch.zeros(n, dtype=torch.bool, device=flat.device)
    torch.ne(srt[1:], srt[:-1], out=new[1:])
    slot = torch.cumsum(new, 0)
    inv = torch.empty_like(slot).scatter_(0, order, slot)
    uniq = torch.full((max(n, size),), fill, dtype=flat.dtype,
                      device=flat.device).scatter_(0, slot, srt)
    return uniq[:size], inv


def fits(ids: torch.Tensor) -> bool:
    """Whether the kernel takes these ids: int32, on a card, at most
    CAPACITY of them."""
    return (ids.is_cuda and ids.dtype == torch.int32
            and ids.numel() <= CAPACITY)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("unique_fill")
    if lib.herald_unique_fill_capacity() != CAPACITY:
        raise RuntimeError(f"unique_fill: the library takes "
                           f"{lib.herald_unique_fill_capacity()} ids a "
                           f"launch, the wrapper {CAPACITY}")
    lib.herald_unique_fill.argtypes = ([ctypes.c_void_p] * 3
                                       + [ctypes.c_int64] * 3
                                       + [ctypes.c_void_p])
    lib.herald_unique_fill.restype = ctypes.c_int
    lib.herald_unique_fill_prepare.restype = ctypes.c_int
    return lib


@functools.cache
def _prepared(index: int):
    """The launcher, once the kernel may take its shared memory on card
    `index` (a device attribute, set at the first call there: a step's
    warm-up, before any capture)."""
    lib = _library()
    with torch.cuda.device(index):
        rc = lib.herald_unique_fill_prepare()
    if rc != 0:
        raise RuntimeError(f"unique_fill: setting the kernel's shared "
                           f"memory failed with CUDA error {rc}")
    return lib.herald_unique_fill


def unique_fill(ids: torch.Tensor, size: int, fill: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids [...] -> (uniq [size] in the ids' dtype, the sorted distinct ids
    cut to `size` or padded with `fill`; inv [N] int64, each id's rank
    among the distinct ids, `size` or more for an id cut off). On the card
    this launches the kernel or raises."""
    flat = ids.reshape(-1)
    if flat.device.type == "cpu":
        return unique_fill_ref(flat, size, fill)
    if not fits(flat):
        raise ValueError(f"unique_fill: the kernel takes at most {CAPACITY} "
                         f"int32 ids on a card, got {flat.numel()} "
                         f"{flat.dtype} on {flat.device}")
    if size < 0:
        raise ValueError(f"unique_fill: size {size} < 0")
    if not _INT32.min <= fill <= _INT32.max:
        raise ValueError(f"unique_fill: fill {fill} is not an int32")
    flat = flat.contiguous()
    n = flat.numel()
    uniq = torch.empty(size, dtype=torch.int32, device=flat.device)
    inv = torch.empty(n, dtype=torch.int64, device=flat.device)
    build.launch("unique_fill", _prepared(flat.device.index), flat.device,
                 flat.data_ptr(), uniq.data_ptr(), inv.data_ptr(), n, size,
                 fill)
    unique_fill.launches += 1
    return uniq, inv


unique_fill.launches = 0
