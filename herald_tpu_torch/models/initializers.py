"""Initializer library (port of `herald_tpu/models/initializers.py`,
reference `python/hetu/initializers.py`).

An initializer is one function `f(gen, shape, dtype) -> tensor` that
draws from the explicit `torch.Generator` `gen`, on its device; the
`Gen*` factories keep the reference's names so layer code reads the same.
`torch.Generator` cannot reproduce `jax.random`'s bits: the functions
keep JAX's distributions, bounds and fan formulas, not its draws.

Fan convention as the reference's (`initializers.py:94-111`):
fan_in = prod(shape[2:]) * shape[1], fan_out = prod(shape[2:]) * shape[0]
— shape[0] is the OUTPUT dim (conv OIHW / torch Linear layout). Note
`models/layers.Linear` stores W as (in, out); pass `initializer=` there
and the helper accounts for it.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def zeros(gen, shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def ones(gen, shape, dtype=torch.float32):
    return torch.ones(shape, dtype=dtype, device=gen.device)


def constant(gen, shape, fill_value=0.0, dtype=torch.float32):
    return torch.full(shape, fill_value, dtype=dtype, device=gen.device)


def random_uniform(gen, shape, minval=-1.0, maxval=1.0,
                   dtype=torch.float32):
    u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return minval + (maxval - minval) * u


def random_normal(gen, shape, mean=0.0, stddev=1.0, dtype=torch.float32):
    return mean + stddev * torch.randn(shape, generator=gen, dtype=dtype,
                                       device=gen.device)


def truncated_normal(gen, shape, mean=0.0, stddev=1.0, dtype=torch.float32):
    """Truncated at +/- 2 sigma like the reference
    (`initializers.py:204-205`: truncnorm(-2.0, 2.0)), drawn as JAX draws
    it: a uniform between the normal CDF's values at -2 and 2, through
    the inverse CDF, clamped into [-2, 2]."""
    lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2, 2))
    u = lo + (hi - lo) * torch.rand(shape, generator=gen,
                                    dtype=torch.float32, device=gen.device)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return (mean + stddev * z.clamp(-2.0, 2.0)).to(dtype)


def _fan_factor(shape, mode):
    assert mode in ("fan_in", "fan_out", "avg"), f"Mode {mode} not valid."
    assert len(shape) >= 2, "General xavier requires >= 2D shapes."
    hw_scale = 1 if len(shape) == 2 else int(np.prod(shape[2:]))
    fan_in = hw_scale * shape[1]
    fan_out = hw_scale * shape[0]
    return {"fan_in": fan_in, "fan_out": fan_out,
            "avg": (fan_in + fan_out) / 2.0}[mode]


def general_xavier_uniform(gen, shape, gain, mode, dtype=torch.float32):
    limit = float(np.sqrt(gain / _fan_factor(shape, mode)))
    return random_uniform(gen, shape, -limit, limit, dtype)


def general_xavier_normal(gen, shape, gain, mode, dtype=torch.float32):
    std = float(np.sqrt(gain / _fan_factor(shape, mode)))
    return random_normal(gen, shape, 0.0, std, dtype)


def xavier_uniform(gen, shape, dtype=torch.float32):
    return general_xavier_uniform(gen, shape, 3.0, "avg", dtype)


def xavier_normal(gen, shape, dtype=torch.float32):
    return general_xavier_normal(gen, shape, 1.0, "avg", dtype)


def he_uniform(gen, shape, dtype=torch.float32):
    return general_xavier_uniform(gen, shape, 6.0, "fan_in", dtype)


def he_normal(gen, shape, dtype=torch.float32):
    return general_xavier_normal(gen, shape, 2.0, "fan_in", dtype)


def lecun_uniform(gen, shape, dtype=torch.float32):
    return general_xavier_uniform(gen, shape, 3.0, "fan_in", dtype)


def lecun_normal(gen, shape, dtype=torch.float32):
    return general_xavier_normal(gen, shape, 1.0, "fan_in", dtype)


# ---- Gen* factories (reference initializers.py:320-373): shape-less ----
def _gen(fn, **kw):
    def init(gen, shape, dtype=torch.float32):
        return fn(gen, shape, dtype=dtype, **kw)
    return init


def GenZeros():
    return _gen(zeros)


def GenOnes():
    return _gen(ones)


def GenConstant(fill_value=0.0):
    return _gen(constant, fill_value=fill_value)


def GenUniform(minval=-1.0, maxval=1.0):
    return _gen(random_uniform, minval=minval, maxval=maxval)


def GenNormal(mean=0.0, stddev=1.0):
    return _gen(random_normal, mean=mean, stddev=stddev)


def GenTruncatedNormal(mean=0.0, stddev=1.0):
    return _gen(truncated_normal, mean=mean, stddev=stddev)


def GenGeneralXavierUniform(gain, mode):
    return _gen(general_xavier_uniform, gain=gain, mode=mode)


def GenGeneralXavierNormal(gain, mode):
    return _gen(general_xavier_normal, gain=gain, mode=mode)


def GenXavierUniform():
    return _gen(xavier_uniform)


def GenXavierNormal():
    return _gen(xavier_normal)


def GenHeUniform():
    return _gen(he_uniform)


def GenHeNormal():
    return _gen(he_normal)


def GenLecunUniform():
    return _gen(lecun_uniform)


def GenLecunNormal():
    return _gen(lecun_normal)
