"""K3 `hot_onehot_push`: the f32 segment sum of grad rows by id.

Port of the Pallas kernel `herald_tpu/ops/pallas/kernels.py:259-282` to a
hand-written CUDA kernel (`csrc/hot_onehot_push.cu`). It keeps the JAX
contract, `(ids [N], grads [N, D] f32/bf16, num_rows) -> f32 [num_rows, D]`:
duplicates accumulate and ids outside [0, num_rows) are dropped. The
Pallas kernel's block-multiple rule on `num_rows` does not apply.

On the card the sum is deterministic: the wrapper orders the positions by
id (`torch.sort(..., stable=True)`, index bookkeeping) and the kernel adds
each segment's rows in position order, so the same inputs give the same
bits on every launch. `hot_onehot_push` launches it for tensors on the card
and uses the plain version `hot_onehot_push_ref` only for tensors on the
CPU, which adds in the same position order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from herald_tpu_torch.ops.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def hot_onehot_push_ref(ids: torch.Tensor, grads: torch.Tensor,
                        num_rows: int) -> torch.Tensor:
    """Plain PyTorch version: bounds mask, then `index_add_` of the f32
    grads into zeros."""
    valid = (ids >= 0) & (ids < num_rows)
    out = torch.zeros((num_rows, grads.shape[1]), dtype=torch.float32,
                      device=grads.device)
    return out.index_add_(0, ids[valid], grads[valid].to(torch.float32))


@functools.cache
def _launcher():
    fn = build.load("hot_onehot_push").herald_hot_onehot_push
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def hot_onehot_push(ids: torch.Tensor, grads: torch.Tensor,
                    num_rows: int) -> torch.Tensor:
    """ids [N] int32/int64, grads [N, D] f32/bf16 -> f32 [num_rows, D].
    On the card this launches the CUDA kernel or raises."""
    if ids.device.type == "cpu" and grads.device.type == "cpu":
        return hot_onehot_push_ref(ids, grads, num_rows)
    if not grads.is_cuda or ids.device != grads.device:
        raise ValueError(f"hot_onehot_push: ids on {ids.device} and grads "
                         f"on {grads.device}; both must be on one card")
    if ids.dim() != 1 or grads.dim() != 2 or grads.shape[0] != ids.shape[0]:
        raise ValueError(f"hot_onehot_push: ids must be [N] and grads "
                         f"[N, D], got {tuple(ids.shape)} and "
                         f"{tuple(grads.shape)}")
    if grads.dtype not in _DTYPE_CODES:
        raise ValueError(f"hot_onehot_push: grads dtype {grads.dtype} not "
                         f"in {list(_DTYPE_CODES)}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"hot_onehot_push: ids dtype {ids.dtype} is not "
                         f"int32 or int64")
    if num_rows < 0:
        raise ValueError(f"hot_onehot_push: num_rows {num_rows} < 0")
    N, D = grads.shape
    out = torch.empty((num_rows, D), dtype=torch.float32, device=grads.device)
    if num_rows == 0 or D == 0:
        return out
    grads = grads.contiguous()
    sorted_ids, order = torch.sort(ids, stable=True)
    fn = _launcher()
    with torch.cuda.device(grads.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(sorted_ids.data_ptr(), order.data_ptr(), grads.data_ptr(),
                out.data_ptr(), N, num_rows, D, _DTYPE_CODES[grads.dtype],
                int(ids.dtype == torch.int64), stream)
    if rc != 0:
        raise RuntimeError(f"hot_onehot_push: kernel launch failed with "
                           f"CUDA error {rc}")
    hot_onehot_push.launches += 1
    return out


hot_onehot_push.launches = 0
