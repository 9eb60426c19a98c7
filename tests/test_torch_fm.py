"""K5 `fm_second_order` of the port against the JAX package: the Pallas
kernel in interpret mode (as tests/test_pallas_kernels.py:39-46 runs it),
DeepFM's inline formula (`herald_tpu/models/dfm.py:44-45`) on the strided
2nd-order view of fused [B, F, D+1] activations, and `jax.grad` of that
formula for the backward.

Tolerances:
- forward: within 1e-6 * sum_d (s_d^2 + q_d) per sample, the size of the
  terms the two f32 sums cancel (s = sum_f v, q = sum_f v^2), since XLA and
  torch add them in other orders;
- backward: rtol 1e-5, atol 1e-6 * max|g| * max|s| against `jax.grad`.
  JAX's autodiff of the inline formula forms g*s - g*v, two roundings,
  where the port forms g * (s - v); where s is close to v the two differ
  by an f32 ulp of g*s (measured 1.8e-6 on values of order 10);
- `torch.autograd.gradcheck` in f64 on the plain path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herald_tpu.ops.pallas import fm_second_order as pallas_fm
from herald_tpu_torch.ops.kernels import (KERNELS, FMSecondOrder,
                                          fm_second_order,
                                          fm_second_order_backward,
                                          fm_second_order_bwd_ref,
                                          fm_second_order_ref)


def _emb(B, F, D, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (B, F, D)).astype(np.float32)


def _inline(second):
    """herald_tpu/models/dfm.py:44-45."""
    s = jnp.sum(second, axis=1)
    return 0.5 * jnp.sum(s * s - jnp.sum(second * second, axis=1), axis=1)


def _scale(e):
    """sum_d (s_d^2 + q_d) per sample: the forward's tolerance unit."""
    s = e.sum(axis=1)
    return (s * s + (e * e).sum(axis=1)).sum(axis=1)


@pytest.mark.parametrize("B", [128, 256])
def test_forward_matches_pallas_interpret(B):
    emb = _emb(B, 26, 16)
    want = np.asarray(pallas_fm(jnp.asarray(emb), interpret=True))
    got = fm_second_order(torch.from_numpy(emb))
    assert got.dtype == torch.float32 and got.shape == (B,)
    assert (np.abs(got.numpy() - want) <= 1e-6 * _scale(emb)).all()
    assert torch.equal(got, fm_second_order_ref(torch.from_numpy(emb)))


def test_forward_on_the_fused_view_matches_the_inline_formula():
    fused = _emb(40, 26, 9, seed=3)               # [B, F, D+1], D = 8
    view = torch.from_numpy(fused)[:, :, 1:]
    assert not view.is_contiguous() and view.storage_offset() == 1
    want = np.asarray(_inline(jnp.asarray(fused)[:, :, 1:]))
    got = fm_second_order(view).numpy()
    assert (np.abs(got - want) <= 1e-6 * _scale(fused[:, :, 1:])).all()
    # a B that is no multiple of the Pallas block, and bf16 input computed
    # in f32
    bf = view.to(torch.bfloat16)
    np.testing.assert_array_equal(fm_second_order(bf).numpy(),
                                  fm_second_order_ref(bf.float()).numpy())


@pytest.mark.parametrize("B", [16, 33])
def test_backward_matches_jax_grad(B):
    fused = _emb(B, 26, 9, seed=4)
    g = np.random.default_rng(5).standard_normal(B).astype(np.float32)

    def f(x):
        return jnp.sum(_inline(x[:, :, 1:]) * g)
    want = np.asarray(jax.grad(f)(jnp.asarray(fused)))
    x = torch.from_numpy(fused).requires_grad_(True)
    y = FMSecondOrder.apply(x[:, :, 1:])
    (y * torch.from_numpy(g)).sum().backward()
    s_max = np.abs(fused[:, :, 1:].sum(axis=1)).max()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(g).max() * s_max)
    assert not x.grad[:, :, 0].any()           # the 1st-order column
    # the wrappers: forward's s into the backward, and s recomputed
    _, s = fm_second_order(x.detach()[:, :, 1:], return_s=True)
    a = fm_second_order_backward(x.detach()[:, :, 1:], torch.from_numpy(g), s)
    b = fm_second_order_bwd_ref(x.detach()[:, :, 1:], torch.from_numpy(g))
    assert torch.equal(a, b) and a.is_contiguous()
    assert torch.equal(a, x.grad[:, :, 1:])


def test_gradcheck_f64():
    """The plain path in f64: the forward's autograd and FMSecondOrder's
    own backward (the plain version on the CPU) against finite
    differences."""
    x = torch.from_numpy(_emb(6, 5, 7, seed=6).astype(np.float64))
    fused = torch.from_numpy(_emb(6, 5, 8, seed=7).astype(np.float64))
    for fn, arg in ((fm_second_order_ref, x),
                    (FMSecondOrder.apply, x),
                    (lambda v: FMSecondOrder.apply(v[:, :, 1:]), fused)):
        assert torch.autograd.gradcheck(fn, (arg.clone().requires_grad_(),))


def test_no_grad_keeps_no_state_and_launches_nothing_on_the_cpu():
    before = {k: f.launches for k, f in KERNELS.items()}
    x = torch.from_numpy(_emb(8, 4, 5)).requires_grad_(True)
    with torch.no_grad():
        y = FMSecondOrder.apply(x)
    assert y.grad_fn is None
    FMSecondOrder.apply(x).sum().backward()
    assert {"fm_second_order", "fm_second_order_backward"} <= set(KERNELS)
    assert {k: f.launches for k, f in KERNELS.items()} == before


def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(chip_smoke.py runs this check on the card)")
    fused = torch.from_numpy(_emb(130, 26, 17, seed=7)).cuda()
    for v in (fused[:, :, 1:], fused[:, :, 1:].to(torch.bfloat16)):
        n0 = fm_second_order.launches
        out, s = fm_second_order(v, return_s=True)
        assert fm_second_order.launches == n0 + 1
        want = fm_second_order_ref(v)
        e = v.float()
        scale = ((e.sum(1) ** 2) + (e * e).sum(1)).sum(1)
        assert bool(((out - want).abs() <= 1e-6 * scale).all())
        assert torch.equal(out, fm_second_order(v))
        g = torch.randn(v.shape[0], device="cuda")
        assert torch.equal(fm_second_order_backward(v, g, s),
                           fm_second_order_bwd_ref(v, g, s))
    with pytest.raises(ValueError, match="must be"):
        fm_second_order_backward(fused[:, :, 1:], g[:3], s)
    torch.cuda.synchronize()
