"""K5 `fm_second_order`: the FM second-order term of DeepFM, forward and
backward.

    out[b] = 0.5 * sum_d ((sum_f v[b, f, d])^2 - sum_f v[b, f, d]^2)
    d out[b] / d v[b, f, d] = s[b, d] - v[b, f, d],   s = sum_f v

Port of the Pallas kernel `herald_tpu/ops/pallas/kernels.py:289-317` to
hand-written CUDA kernels (`csrc/fm_second_order.cu`). It keeps the JAX
contract, `emb [B, F, D]` f32 or bf16 -> f32 `[B]`, computed in f32; the
Pallas kernel's block-multiple rule on B does not apply. The Pallas kernel
has no backward (JAX differentiates DeepFM's inline formula,
`herald_tpu/models/dfm.py:44-45`); the port's is the second kernel of the
same source, wrapped with the forward in the autograd function
`FMSecondOrder`.

The input may be a strided view: DeepFM passes `emb[:, :, 1:]` of its
fused [B, F, D+1] activations as it is, and the wrappers hand the kernel
its data pointer (storage offset included) and the strides of B and F.
Only a view whose last stride is not 1 is copied first.

`fm_second_order` and `fm_second_order_backward` launch their kernels for
tensors on the card (or raise) and use the plain versions
`fm_second_order_ref` and `fm_second_order_bwd_ref` only for tensors on
the CPU. Each has its own launch counter.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from herald_tpu_torch.ops.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _widen(emb: torch.Tensor) -> torch.Tensor:
    """emb in f32, or in f64 where it is f64 (the gradient checks)."""
    return emb.to(torch.promote_types(emb.dtype, torch.float32))


def fm_second_order_ref(emb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward, in f32 (f64 for f64 input):
    the Pallas body."""
    e = _widen(emb)
    s = e.sum(dim=1)
    return 0.5 * (s * s - (e * e).sum(dim=1)).sum(dim=1)


def fm_second_order_bwd_ref(emb: torch.Tensor, g: torch.Tensor,
                            s: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Plain PyTorch version of the backward: g[b] * (s[b, d] - v[b, f, d])
    in f32, rounded once to emb's dtype. `s` (f32 [B, D]) is recomputed
    when not given."""
    e = _widen(emb)
    if s is None:
        s = e.sum(dim=1)
    grad = g.to(e.dtype)[:, None, None] * (s[:, None, :] - e)
    return grad.to(emb.dtype)


def _check(name: str, emb: torch.Tensor) -> torch.Tensor:
    """Raise unless emb is [B, F, D] f32/bf16 on a card; a copy only when
    its last stride is not 1."""
    if not emb.is_cuda:
        raise ValueError(f"{name}: emb on {emb.device}; it must be on a card")
    if emb.dim() != 3:
        raise ValueError(f"{name}: emb must be [B, F, D], got "
                         f"{tuple(emb.shape)}")
    if emb.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: emb dtype {emb.dtype} not in "
                         f"{list(_DTYPE_CODES)}")
    return emb if emb.stride(2) == 1 else emb.contiguous()


@functools.cache
def _launchers():
    lib = build.load("fm_second_order")
    fwd = lib.herald_fm_second_order
    fwd.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.herald_fm_second_order_backward
    bwd.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return fwd, bwd


def fm_second_order(emb: torch.Tensor, return_s: bool = False):
    """emb [B, F, D] f32/bf16, any strides -> f32 [B]; with `return_s`
    also s = sum_f emb, f32 [B, D], which the backward takes. On the card
    this launches the CUDA kernel or raises."""
    if emb.device.type == "cpu":
        out = fm_second_order_ref(emb)
        return (out, _widen(emb).sum(dim=1)) if return_s else out
    emb = _check("fm_second_order", emb)
    B, F, D = emb.shape
    out = torch.empty((B,), dtype=torch.float32, device=emb.device)
    s = torch.empty((B, D), dtype=torch.float32, device=emb.device) \
        if return_s else None
    if B:
        fwd, _ = _launchers()
        build.launch("fm_second_order", fwd, emb.device, emb.data_ptr(),
                     emb.stride(0), emb.stride(1), B, F, D,
                     _DTYPE_CODES[emb.dtype], out.data_ptr(),
                     None if s is None else s.data_ptr())
        fm_second_order.launches += 1
    return (out, s) if return_s else out


def fm_second_order_backward(emb: torch.Tensor, g: torch.Tensor,
                             s: torch.Tensor) -> torch.Tensor:
    """emb [B, F, D] f32/bf16 (any strides), g [B], s f32 [B, D] ->
    contiguous [B, F, D] grad in emb's dtype. On the card this launches
    the CUDA kernel or raises."""
    if emb.device.type == "cpu" and g.device.type == "cpu" \
            and s.device.type == "cpu":
        return fm_second_order_bwd_ref(emb, g, s)
    emb = _check("fm_second_order_backward", emb)
    B, F, D = emb.shape
    if g.device != emb.device or s.device != emb.device \
            or tuple(g.shape) != (B,) or tuple(s.shape) != (B, D):
        raise ValueError(f"fm_second_order_backward: g {tuple(g.shape)} on "
                         f"{g.device} and s {tuple(s.shape)} on {s.device} "
                         f"must be [B] and [B, D] on {emb.device}, with "
                         f"[B, F, D] = {tuple(emb.shape)}")
    grad = torch.empty((B, F, D), dtype=emb.dtype, device=emb.device)
    if grad.numel() == 0:
        return grad
    g = g.to(torch.float32).contiguous()
    s = s.to(torch.float32).contiguous()
    _, bwd = _launchers()
    build.launch("fm_second_order_backward", bwd, emb.device, emb.data_ptr(),
                 emb.stride(0), emb.stride(1), B, F, D,
                 _DTYPE_CODES[emb.dtype], g.data_ptr(), s.data_ptr(),
                 grad.data_ptr())
    fm_second_order_backward.launches += 1
    return grad


fm_second_order.launches = 0
fm_second_order_backward.launches = 0


class FMSecondOrder(torch.autograd.Function):
    """y2 of DeepFM with K5 both ways. The forward keeps s = sum_f emb
    (f32 [B, D]) for the backward when emb needs a gradient; in eval it
    writes none. The backward returns the grad of the view it was given;
    autograd places it into the fused [B, F, D+1] activations."""

    @staticmethod
    def forward(ctx, emb: torch.Tensor) -> torch.Tensor:
        if not ctx.needs_input_grad[0]:
            return fm_second_order(emb)
        out, s = fm_second_order(emb, return_s=True)
        ctx.save_for_backward(emb, s)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        emb, s = ctx.saved_tensors
        return fm_second_order_backward(emb, g, s)
