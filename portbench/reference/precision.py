"""Matrix products at a stated precision, for the reference and its
controls. `MATMUL[name](a, b)` multiplies with autograd:

- "float32": f32 products with TF32 off (the configuration's own);
- "tf32": TF32 as the card's tensor cores take it, made exact here: both
  operands of every product (the forward and both of the backward's)
  rounded to TF32's 10 mantissa bits, to nearest even, then multiplied
  and summed in f32. It is the same on every device and does not depend
  on which kernel a library picks;
- "bfloat16": operands and result in bfloat16, as a bf16 tower computes.
"""

import torch


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32's mantissa, to nearest even."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    return ((b + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class _TF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return to_tf32(a) @ to_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        return g @ to_tf32(b).transpose(-1, -2), \
            to_tf32(a).transpose(-1, -2) @ g


def _f32(a, b):
    return a @ b


def _bf16(a, b):
    return (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).to(torch.float32)


MATMUL = {"float32": _f32, "tf32": _TF32.apply, "bfloat16": _bf16}


def no_tf32() -> None:
    """Keep the library's TF32 out of f32 products and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
