"""The port's initializers (`herald_tpu_torch/models/initializers.py`)
against `herald_tpu/models/initializers.py` on the CPU. `torch.Generator`
cannot reproduce `jax.random`'s bits, so each function is held to JAX's
by its exact bounds and fan factors, and by its moments: the mean within
5 standard errors of the expected one and the standard deviation within
2% of it, over 100,000 draws (a uniform over [-l, l] has sd l/sqrt(3), a
normal truncated at 2 sigma 0.8796 sigma), the same statistics JAX's
draws give."""

import jax
import numpy as np
import pytest
import torch

from herald_tpu.models import initializers as JI
from herald_tpu_torch.models import initializers as I
from herald_tpu_torch.models import layers as L

N = 100_000
TRUNC_SD = 0.87962566       # sd of N(0, 1) truncated to [-2, 2]


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("shape", [(64, 256), (256, 64), (8, 4, 3, 3),
                                   (5, 7, 2, 3, 4)])
@pytest.mark.parametrize("mode", ["fan_in", "fan_out", "avg"])
def test_fan_factor_is_jaxs(shape, mode):
    assert I._fan_factor(shape, mode) == JI._fan_factor(shape, mode)


def _moments(a, mean, sd):
    a = np.asarray(a, np.float64).reshape(-1)
    assert abs(a.mean() - mean) < 5 * sd / np.sqrt(a.size)
    assert abs(a.std() / sd - 1) < 0.02


# name: (gain-limit or sd as a function of the fan factors, uniform?)
UNIFORM = {"xavier_uniform": (3.0, "avg"), "he_uniform": (6.0, "fan_in"),
           "lecun_uniform": (3.0, "fan_in")}
NORMAL = {"xavier_normal": (1.0, "avg"), "he_normal": (2.0, "fan_in"),
          "lecun_normal": (1.0, "fan_in")}


@pytest.mark.parametrize("name", sorted(UNIFORM) + sorted(NORMAL))
def test_xavier_family_bounds_and_moments(name):
    shape = (100, 50, 4, 5)                  # 100,000 draws, OIHW fans
    gain, mode = {**UNIFORM, **NORMAL}[name]
    scale = float(np.sqrt(gain / JI._fan_factor(shape, mode)))
    mine = getattr(I, name)(_gen(), shape)
    theirs = np.asarray(getattr(JI, name)(jax.random.PRNGKey(0), shape))
    assert tuple(mine.shape) == shape and mine.dtype == torch.float32
    for a in (mine.numpy(), theirs):
        if name in UNIFORM:
            assert a.max() <= scale and a.min() >= -scale
            assert a.max() > 0.999 * scale    # it fills the range
            _moments(a, 0.0, scale / np.sqrt(3.0))
        else:
            _moments(a, 0.0, scale)


def test_truncated_normal_bounds_and_moments():
    mine = I.truncated_normal(_gen(1), (N,), mean=0.5, stddev=0.1).numpy()
    theirs = np.asarray(JI.truncated_normal(jax.random.PRNGKey(1), (N,),
                                            mean=0.5, stddev=0.1))
    for a in (mine, theirs):
        # truncation at +/- 2 sigma around the mean
        assert a.max() <= 0.5 + 2 * 0.1 + 1e-6
        assert a.min() >= 0.5 - 2 * 0.1 - 1e-6
        assert a.max() > 0.5 + 1.99 * 0.1 and a.min() < 0.5 - 1.99 * 0.1
        _moments(a, 0.5, 0.1 * TRUNC_SD)


def test_uniform_and_normal_moments():
    a = I.random_uniform(_gen(2), (N,), minval=-3.0, maxval=1.0).numpy()
    assert a.min() >= -3.0 and a.max() < 1.0
    _moments(a, -1.0, 4.0 / np.sqrt(12.0))
    _moments(I.random_normal(_gen(3), (N,), mean=1.0, stddev=0.25).numpy(),
             1.0, 0.25)


def test_constants_and_gen_factories():
    g = _gen(2)
    for mine, theirs in ((I.zeros(g, (3, 2)), JI.zeros(None, (3, 2))),
                         (I.ones(g, (3,)), JI.ones(None, (3,))),
                         (I.constant(g, (2, 2), fill_value=7.0),
                          JI.constant(None, (2, 2), fill_value=7.0))):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    # a Gen* factory is the direct call from the same generator state
    f = I.GenNormal(mean=1.0, stddev=0.25)
    assert torch.equal(f(_gen(5), (4, 4)),
                       I.random_normal(_gen(5), (4, 4), mean=1.0,
                                       stddev=0.25))
    h = I.GenGeneralXavierUniform(gain=2.0, mode="fan_out")
    assert torch.equal(h(_gen(5), (8, 4)),
                       I.general_xavier_uniform(_gen(5), (8, 4), 2.0,
                                                "fan_out"))
    assert torch.equal(I.GenConstant(3.0)(g, (2,)), torch.full((2,), 3.0))
    names = {n for n in dir(JI) if n.startswith("Gen")}
    assert names == {n for n in dir(I) if n.startswith("Gen")}
    for n in names:
        assert getattr(I, n).__code__.co_varnames == \
            getattr(JI, n).__code__.co_varnames


def test_layers_take_initializers():
    """layers.Linear(initializer=GenXavierUniform()) is the reference's
    Linear default (`layers/linear.py:14`), and stddev=None the same
    draw."""
    lin = L.Linear(16, 8, bias=False, initializer=I.GenXavierUniform())
    a = lin.init(_gen(3))["W"]
    lim = np.sqrt(3.0 / ((16 + 8) / 2.0))
    assert tuple(a.shape) == (16, 8)
    assert float(a.max()) <= lim and float(a.min()) >= -lim
    assert torch.equal(a, L.Linear(16, 8, bias=False,
                                   stddev=None).init(_gen(3))["W"])
    conv = L.Conv2d(3, 8, kernel_size=3, initializer=I.GenHeNormal())
    w = conv.init(_gen(4))["W"]
    assert tuple(w.shape) == (8, 3, 3, 3)
    assert abs(float(w.std()) - np.sqrt(2.0 / (3 * 9))) < 0.03
