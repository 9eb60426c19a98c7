"""K4 `hot_onehot_gather`: out[i] = hot_table[ids[i]], a zero row for ids
outside [0, H), negative ids included; and its add form
`hot_onehot_gather_add_`: acc[i] += hot_table[ids[i]] in f32, in place,
for the in-range ids only.

Port of the Pallas kernel `herald_tpu/ops/pallas/kernels.py:218-243` to a
hand-written CUDA kernel (`csrc/hot_onehot_gather.cu`, one source, both
forms). The Pallas kernel multiplies a bf16 one-hot by the whole hot
block on the MXU, which is exact only for bf16-representable tables; the
CUDA kernel copies the selected rows, so it is exactly `hot_table[ids]`
(zero-filled) for f32 and bf16 alike, and has no block-multiple rule on N.

The cached engine's pinned tier reads through the add form: the JAX
engine's `emb_uniq + hot_table.at[where((uniq >= 0) & (uniq < P), uniq,
P + 1)].get(mode="fill").astype(f32)` (`herald_tpu/train/cached.py:
461-467`) is one launch on the raw `uniq` (-1 padding, ids >= P) that
reads and adds only the hot rows and allocates nothing. Its one
difference: a cold row holding -0.0 keeps it, where `x + 0.0` gives
+0.0; the two compare equal.

Each form launches the kernel for tensors on the card and uses its plain
version (`hot_onehot_gather_ref`, `hot_onehot_gather_add_ref`) only for
tensors on the CPU. Each has its own launch counter.
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


def hot_onehot_gather_add_ref(acc: torch.Tensor, hot_table: torch.Tensor,
                              ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the add form: `acc[valid] +=
    hot_table[ids[valid]].float()`, in place on `acc` (any row stride);
    the rows of ids outside [0, H) are not written."""
    valid = (ids >= 0) & (ids < hot_table.shape[0])
    pos = valid.nonzero().squeeze(1)
    acc.index_copy_(0, pos, acc.index_select(0, pos) + hot_table.index_select(
        0, ids.index_select(0, pos)).float())
    return acc


@functools.cache
def _launcher():
    fn = build.load("hot_onehot_gather").herald_hot_onehot_gather
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _add_launcher():
    fn = build.load("hot_onehot_gather").herald_hot_onehot_gather_add
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
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


def check_add_args(acc: torch.Tensor, hot_table: torch.Tensor,
                   ids: torch.Tensor) -> None:
    """Raise unless hot_table [H, D] f32/bf16 and ids [N] int32/int64 are
    what K4 takes (`check_gather_args`) and acc is an f32 [N, D] on the
    same card whose last dim is contiguous (any row stride that keeps its
    rows apart)."""
    check_gather_args("hot_onehot_gather_add_", hot_table, ids)
    if acc.device != hot_table.device:
        raise ValueError(f"hot_onehot_gather_add_: acc on {acc.device}, "
                         f"table on {hot_table.device}; all must be on one "
                         f"card")
    if acc.dtype != torch.float32:
        raise ValueError(f"hot_onehot_gather_add_: acc dtype {acc.dtype} is "
                         f"not float32")
    want = (ids.shape[0], hot_table.shape[1])
    if tuple(acc.shape) != want:
        raise ValueError(f"hot_onehot_gather_add_: acc must be {list(want)}, "
                         f"got {list(acc.shape)}")
    if acc.numel() and (acc.stride(1) != 1 or (
            acc.shape[0] > 1 and acc.stride(0) < acc.shape[1])):
        raise ValueError(f"hot_onehot_gather_add_: acc strides "
                         f"{acc.stride()}: its last dim must be contiguous "
                         f"and its rows apart")


def hot_onehot_gather_add_(acc: torch.Tensor, hot_table: torch.Tensor,
                           ids: torch.Tensor) -> torch.Tensor:
    """acc [N, D] f32 += hot_table[ids] widened to f32, in place, for the
    ids inside [0, H); returns acc. On the card this launches the CUDA
    kernel or raises; it allocates nothing."""
    if (acc.device.type == "cpu" and hot_table.device.type == "cpu"
            and ids.device.type == "cpu"):
        return hot_onehot_gather_add_ref(acc, hot_table, ids)
    check_add_args(acc, hot_table, ids)
    H, D = hot_table.shape
    N = ids.shape[0]
    if N == 0 or D == 0:
        return acc
    build.launch("hot_onehot_gather_add_", _add_launcher(), hot_table.device,
                 hot_table.data_ptr(), ids.data_ptr(), acc.data_ptr(), H, D,
                 N, acc.stride(0), DTYPE_CODES[hot_table.dtype],
                 int(ids.dtype == torch.int64))
    hot_onehot_gather_add_.launches += 1
    return acc


hot_onehot_gather_add_.launches = 0
