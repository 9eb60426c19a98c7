"""K4 `hot_onehot_gather`: out[i] = hot_table[ids[i]], a zero row for ids
outside [0, H), negative ids included.

Port of the Pallas kernel `herald_tpu/ops/pallas/kernels.py:218-243` to a
hand-written CUDA kernel (`csrc/hot_onehot_gather.cu`). The Pallas kernel
multiplies a bf16 one-hot by the whole hot block on the MXU, which is
exact only for bf16-representable tables; the CUDA kernel copies the
selected rows, so it is exactly `hot_table[ids]` (zero-filled) for f32
and bf16 alike, and has no block-multiple rule on N.

On Hopper this function is the same as K1's (`gather.py`). K4 stays its
own kernel, with its own source, launch counter and PERF.md row, because
it has its own call site and shape: the cached engine's pinned tier, a
block of H <= a few thousand rows that every step re-reads at the step's
unique ids (`herald_tpu/train/cached.py:461-467`). The kernel's bounds
check is the pinned mask there: `where((uniq >= 0) & (uniq < P), uniq,
P + 1)` followed by a fill read equals `hot_onehot_gather(hot_table,
uniq)` on the raw `uniq` (-1 padding, ids >= P).

`hot_onehot_gather` launches the kernel for tensors on the card and uses
the plain version `hot_onehot_gather_ref` only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from herald_tpu_torch.ops.kernels import build
from herald_tpu_torch.ops.kernels.gather import (DTYPE_CODES, check_gather_args,
                                                 embedding_gather_ref)


def hot_onehot_gather_ref(hot_table: torch.Tensor, ids: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch version, K1's (bounds mask, `index_select` on the
    clamped ids, zero the out-of-range rows)."""
    return embedding_gather_ref(hot_table, ids)


@functools.cache
def _launcher():
    fn = build.load("hot_onehot_gather").herald_hot_onehot_gather
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def hot_onehot_gather(hot_table: torch.Tensor, ids: torch.Tensor
                      ) -> torch.Tensor:
    """hot_table [H, D] f32/bf16, ids [N] int32/int64 -> [N, D] in the
    table dtype. On the card this launches the CUDA kernel or raises."""
    if hot_table.device.type == "cpu" and ids.device.type == "cpu":
        return hot_onehot_gather_ref(hot_table, ids)
    check_gather_args("hot_onehot_gather", hot_table, ids)
    H, D = hot_table.shape
    N = ids.shape[0]
    out = torch.empty((N, D), dtype=hot_table.dtype, device=hot_table.device)
    if N == 0 or D == 0:
        return out
    build.launch("hot_onehot_gather", _launcher(), hot_table.device,
                 hot_table.data_ptr(), ids.data_ptr(), out.data_ptr(), H, D,
                 N, DTYPE_CODES[hot_table.dtype],
                 int(ids.dtype == torch.int64))
    hot_onehot_gather.launches += 1
    return out


hot_onehot_gather.launches = 0
