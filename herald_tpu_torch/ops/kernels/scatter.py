"""K2 `rows_scatter_add`: table[ids] += grads.to(table.dtype), in place,
for unique ids.

Port of the Pallas kernel `herald_tpu/ops/pallas/kernels.py:148-190` to a
hand-written CUDA kernel (`csrc/rows_scatter_add.cu`). The Pallas kernel
donates the table and returns it; the port updates it in place and
returns the same tensor. Ids outside [0, R) are skipped (the JAX engine's
`mode="drop"` write; the Pallas kernel has no bounds check).

The ids MUST be unique, as for the Pallas kernel: combine duplicates first
(`ops.embedding.scatter_add_rows` does, through K3). The wrapper does not
check this on the card, since that would cost a sort and a wait; with
duplicates the kernel's row updates race and one of them is lost.

`rows_scatter_add` launches the kernel for tensors on the card and uses the
plain version `rows_scatter_add_ref` only for tensors on the CPU. The two
are bit-exact: both round the grad to the table dtype and then add once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from herald_tpu_torch.ops.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rows_scatter_add_ref(table: torch.Tensor, ids: torch.Tensor,
                         grads: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: bounds mask, then `index_put_` of
    `table[ids] + grads.to(table.dtype)`. In place; returns `table`."""
    valid = (ids >= 0) & (ids < table.shape[0])
    idx = ids[valid]
    return table.index_put_((idx,), table[idx] + grads[valid].to(table.dtype))


@functools.cache
def _launcher():
    fn = build.load("rows_scatter_add").herald_rows_scatter_add
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rows_scatter_add(table: torch.Tensor, ids: torch.Tensor,
                     grads: torch.Tensor) -> torch.Tensor:
    """table [R, D] f32/bf16 (updated in place), unique ids [N] int32/int64,
    grads [N, D] f32/bf16 -> table. On the card this launches the CUDA
    kernel or raises."""
    if table.device.type == "cpu" and ids.device.type == "cpu" \
            and grads.device.type == "cpu":
        return rows_scatter_add_ref(table, ids, grads)
    if not table.is_cuda or ids.device != table.device \
            or grads.device != table.device:
        raise ValueError(f"rows_scatter_add: table on {table.device}, ids "
                         f"on {ids.device}, grads on {grads.device}; all "
                         f"must be on one card")
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
    R, D = table.shape
    N = ids.shape[0]
    if N == 0 or D == 0:
        return table
    fn = _launcher()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(table.data_ptr(), ids.data_ptr(), grads.data_ptr(), R, D, N,
                _DTYPE_CODES[table.dtype], _DTYPE_CODES[grads.dtype],
                int(ids.dtype == torch.int64), stream)
    if rc != 0:
        raise RuntimeError(f"rows_scatter_add: kernel launch failed with "
                           f"CUDA error {rc}")
    rows_scatter_add.launches += 1
    return table


rows_scatter_add.launches = 0
