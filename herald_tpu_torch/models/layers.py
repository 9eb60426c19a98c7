"""Layers API: composable (init, apply) building blocks (port of
`herald_tpu/models/layers.py`, reference `python/hetu/layers/`).

A Layer is a pure pair — `init(gen) -> params` (a dict of tensors, a list
of them for the combinators, possibly empty) drawn from the explicit
`torch.Generator` `gen`, and `apply(params, x, *, rng=None, train=False)
-> y` — like the hand-written towers of `models/base.py`, so a
layers-built tower's params drop into the engine's state. Stateless
layers carry empty params. DropOut takes its randomness from an explicit
generator (`rng=`) when `train=True`; a combinator hands its one
generator to each sub-layer in turn, so two DropOuts draw different
masks.

Semantics as JAX's: `gelu` is the tanh form, BatchNorm normalizes with
the biased batch variance, the pools pad explicitly (-inf for max, zeros
for the average, which divides by k² with the padding counted).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence as Seq

import torch
import torch.nn.functional as F


def _gelu(x):
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


@dataclasses.dataclass(frozen=True)
class Layer:
    """A functional layer: params = init(gen); y = apply(params, x)."""
    init: Callable
    apply: Callable

    def __call__(self, params, x, **kw):
        return self.apply(params, x, **kw)


def _stateless(fn) -> Layer:
    return Layer(init=lambda gen: {},
                 apply=lambda params, x, **kw: fn(x))


def Identity() -> Layer:
    return _stateless(lambda x: x)


def Relu() -> Layer:
    return _stateless(torch.relu)


def Gelu() -> Layer:
    return _stateless(_gelu)


def Reshape(shape: Seq[int]) -> Layer:
    return _stateless(lambda x: x.reshape(shape))


def Linear(in_features: int, out_features: int, bias: bool = True,
           activation: Optional[str] = None, stddev: float = 0.01,
           initializer=None) -> Layer:
    """Reference `layers/linear.py`: weight + optional bias + optional
    activation. W is (in, out) and drawn as stddev * N(0, 1), as
    `models/base.mlp_init`; stddev=None draws Xavier-uniform, and an
    `initializer=` from `models/initializers` gets the (in, out) shape
    (the reference's, `linear.py:28-29`)."""
    act = {None: None, "relu": torch.relu, "gelu": _gelu}[activation]

    def init(gen):
        if initializer is not None:
            W = initializer(gen, (in_features, out_features))
        elif stddev is None:   # GenXavierUniform
            from herald_tpu_torch.models.initializers import xavier_uniform
            W = xavier_uniform(gen, (in_features, out_features))
        else:
            W = stddev * torch.randn((in_features, out_features),
                                     generator=gen, device=gen.device)
        p = {"W": W}
        if bias:
            p["b"] = torch.zeros((out_features,), device=gen.device)
        return p

    def apply(p, x, **kw):
        y = x @ p["W"]
        if bias:
            y = y + p["b"]
        return act(y) if act else y

    return Layer(init=init, apply=apply)


def Conv2d(in_channels: int, out_channels: int, kernel_size: int,
           stride: int = 1, padding: int = 0,
           activation: Optional[str] = None, stddev: float = 0.1,
           initializer=None) -> Layer:
    """NCHW conv (reference `layers/conv.py`) with OIHW weights, so the
    `models/initializers` fan math applies directly."""
    act = {None: None, "relu": torch.relu}[activation]

    def init(gen):
        k = kernel_size
        shape = (out_channels, in_channels, k, k)
        if initializer is not None:
            return {"W": initializer(gen, shape)}
        return {"W": stddev * torch.randn(shape, generator=gen,
                                          device=gen.device)}

    def apply(p, x, **kw):
        y = F.conv2d(x, p["W"], stride=stride, padding=padding)
        return act(y) if act else y

    return Layer(init=init, apply=apply)


def MaxPool2d(kernel_size: int, stride: int, padding: int = 0) -> Layer:
    p = padding
    return _stateless(lambda x: F.max_pool2d(
        F.pad(x, (p, p, p, p), value=float("-inf")), kernel_size, stride))


def AvgPool2d(kernel_size: int, stride: int, padding: int = 0) -> Layer:
    p = padding
    return _stateless(lambda x: F.avg_pool2d(
        F.pad(x, (p, p, p, p)), kernel_size, stride))


def BatchNorm(num_channels: int, eps: float = 1e-5) -> Layer:
    """Per-batch normalization over (N, H, W) of NCHW with the biased
    variance, learnable scale/bias (reference
    `layers/normalization.py`)."""
    def init(gen):
        return {"scale": torch.ones((1, num_channels, 1, 1),
                                    device=gen.device),
                "bias": torch.zeros((1, num_channels, 1, 1),
                                    device=gen.device)}

    def apply(p, x, **kw):
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = x.var(dim=(0, 2, 3), keepdim=True, correction=0)
        return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]

    return Layer(init=init, apply=apply)


def DropOut(p: float = 0.5) -> Layer:
    """Identity at eval; with train=True it needs `rng`, a
    torch.Generator on x's device (reference `layers/dropout.py` keeps the
    RNG implicit)."""
    def apply(params, x, *, rng=None, train=False, **kw):
        if not train or p == 0.0:
            return x
        assert rng is not None, "DropOut(train=True) needs rng="
        keep = torch.rand(x.shape, generator=rng, device=x.device) < 1.0 - p
        return torch.where(keep, x / (1.0 - p), 0.0)

    return Layer(init=lambda gen: {}, apply=apply)


def Concatenate(axis: int = -1) -> Layer:
    """Applies to a SEQUENCE of inputs (reference `layers/concatenate.py`
    Concatenate)."""
    return Layer(init=lambda gen: {},
                 apply=lambda params, xs, **kw: torch.cat(list(xs), axis))


def _init_all(layers):
    return lambda gen: [l.init(gen) for l in layers]


def ConcatenateLayers(layers: Seq[Layer], axis: int = -1) -> Layer:
    """Run each layer on the same input, concat outputs (reference
    ConcatenateLayers)."""
    def apply(params, x, **kw):
        return torch.cat([l.apply(p, x, **kw)
                          for l, p in zip(layers, params)], axis)

    return Layer(init=_init_all(layers), apply=apply)


def SumLayers(layers: Seq[Layer]) -> Layer:
    """Run each layer on the same input, sum outputs (reference
    `layers/sum.py` SumLayers)."""
    def apply(params, x, **kw):
        out = None
        for l, p in zip(layers, params):
            y = l.apply(p, x, **kw)
            out = y if out is None else out + y
        return out

    return Layer(init=_init_all(layers), apply=apply)


def Sequence(*layers: Layer) -> Layer:
    """Chain layers (reference `layers/sequence.py`)."""
    def apply(params, x, **kw):
        for l, p in zip(layers, params):
            x = l.apply(p, x, **kw)
        return x

    return Layer(init=_init_all(layers), apply=apply)
