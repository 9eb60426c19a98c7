"""K2 `rows_scatter_add`: table[ids] += grads.to(table.dtype), or with a
learning rate table[ids] += (-lr * grads).to(table.dtype), in place, for
unique ids.

Port of the Pallas kernel `herald_tpu/ops/pallas/kernels.py:148-190` to a
hand-written CUDA kernel (`csrc/rows_scatter_add.cu`). The Pallas kernel
donates the table and returns it; the port updates it in place and
returns the same tensor. Ids outside [0, R) are skipped (the JAX engine's
`mode="drop"` write; the Pallas kernel has no bounds check).

The ids MUST be unique, as for the Pallas kernel: combine duplicates first
(`ops.embedding.scatter_add_rows` does, through K3). The wrapper does not
check this on the card, since that would cost a sort and a wait; with
duplicates the kernel's row updates race and one of them is lost.

`lr` is the SGD step's 0-d f32 learning rate, on the tensors' device (it
is never read back to the host), with f32 grads. The kernel negates it
(exact) and multiplies each grad once, rounded to nearest: `-lr * grads`
as torch computes it, so the caller launches nothing for the scaling.

`rows_scatter_add` launches the kernel for tensors on the card and uses the
plain version `rows_scatter_add_ref` only for tensors on the CPU. The two
are bit-exact: both round the grad to the table dtype and then add once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from herald_tpu_torch.ops.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_lr(lr: Optional[torch.Tensor], grads: torch.Tensor) -> None:
    """Raise unless lr is None, or a 0-d float32 tensor beside f32 grads on
    their device."""
    if lr is None:
        return
    if not isinstance(lr, torch.Tensor) or lr.dim() != 0 \
            or lr.dtype != torch.float32:
        raise ValueError(f"rows_scatter_add: lr must be a 0-d float32 "
                         f"tensor, got {lr!r}")
    if grads.dtype != torch.float32:
        raise ValueError(f"rows_scatter_add: lr scales float32 grads, got "
                         f"{grads.dtype}")
    if lr.device != grads.device:
        raise ValueError(f"rows_scatter_add: lr on {lr.device} and grads "
                         f"on {grads.device}; both must be on one device")


def rows_scatter_add_ref(table: torch.Tensor, ids: torch.Tensor,
                         grads: torch.Tensor,
                         lr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: `-lr * grads` when lr is given, bounds mask,
    then `index_put_` of `table[ids] + grads.to(table.dtype)`. In place;
    returns `table`."""
    check_lr(lr, grads)
    if lr is not None:
        grads = -lr * grads
    valid = (ids >= 0) & (ids < table.shape[0])
    idx = ids[valid]
    return table.index_put_((idx,), table[idx] + grads[valid].to(table.dtype))


@functools.cache
def _launcher():
    fn = build.load("rows_scatter_add").herald_rows_scatter_add
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_scatter_args(table: torch.Tensor, ids: torch.Tensor,
                       grads: torch.Tensor,
                       lr: Optional[torch.Tensor]) -> None:
    """Raise unless table [R, D] and grads [N, D] f32/bf16, ids [N]
    int32/int64 and lr (None, or 0-d f32 with f32 grads) lie, contiguous,
    on one card: what K2 takes."""
    if not table.is_cuda or ids.device != table.device \
            or grads.device != table.device:
        raise ValueError(f"rows_scatter_add: table on {table.device}, ids "
                         f"on {ids.device}, grads on {grads.device}; all "
                         f"must be on one card")
    check_lr(lr, grads)
    if table.dim() != 2 or ids.dim() != 1 or grads.dim() != 2 \
            or grads.shape != (ids.shape[0], table.shape[1]):
        raise ValueError(f"rows_scatter_add: table must be [R, D], ids [N] "
                         f"and grads [N, D], got {tuple(table.shape)}, "
                         f"{tuple(ids.shape)} and {tuple(grads.shape)}")
    if table.dtype not in _DTYPE_CODES or grads.dtype not in _DTYPE_CODES:
        raise ValueError(f"rows_scatter_add: table dtype {table.dtype} and "
                         f"grads dtype {grads.dtype} must be in "
                         f"{list(_DTYPE_CODES)}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"rows_scatter_add: ids dtype {ids.dtype} is not "
                         f"int32 or int64")
    if not (table.is_contiguous() and ids.is_contiguous()
            and grads.is_contiguous()):
        raise ValueError("rows_scatter_add: table, ids and grads must be "
                         "contiguous")


def rows_scatter_add(table: torch.Tensor, ids: torch.Tensor,
                     grads: torch.Tensor,
                     lr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """table [R, D] f32/bf16 (updated in place), unique ids [N] int32/int64,
    grads [N, D] f32/bf16, optional lr (0-d f32, with f32 grads) -> table.
    On the card this launches the CUDA kernel or raises."""
    if table.device.type == "cpu" and ids.device.type == "cpu" \
            and grads.device.type == "cpu":
        return rows_scatter_add_ref(table, ids, grads, lr)
    check_scatter_args(table, ids, grads, lr)
    R, D = table.shape
    N = ids.shape[0]
    if N == 0 or D == 0:
        return table
    build.launch("rows_scatter_add", _launcher(), table.device,
                 table.data_ptr(), ids.data_ptr(), grads.data_ptr(),
                 None if lr is None else lr.data_ptr(), R, D, N,
                 _DTYPE_CODES[table.dtype], _DTYPE_CODES[grads.dtype],
                 int(ids.dtype == torch.int64))
    rows_scatter_add.launches += 1
    return table


rows_scatter_add.launches = 0
