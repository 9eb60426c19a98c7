"""The port's layers (`herald_tpu_torch/models/layers.py`) against
`herald_tpu/models/layers.py` on the CPU: JAX's params go through numpy
into the port, and each layer gives JAX's outputs within 1e-6 (f32), the
combinators included; DropOut is the identity at eval and at train keeps
1 - p of its inputs, scaled by 1 / (1 - p). `torch.Generator` cannot
reproduce `jax.random`'s bits, so masks and fresh inits are held by their
shapes and statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herald_tpu.models import layers as JL
from herald_tpu_torch.models import layers as L
from herald_tpu_torch.models.base import mlp_apply


def _bridge(tree):
    """JAX params (dicts and lists of arrays) as the port's tensors."""
    if isinstance(tree, dict):
        return {k: _bridge(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_bridge(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def _same(pair, x, seed=0, **kw):
    """Init JAX's layer, bridge, and compare both applies on x."""
    jl, tl = pair
    jp = jl.init(jax.random.PRNGKey(seed))
    tp = _bridge(jp)
    assert _shapes(tl.init(torch.Generator().manual_seed(seed))) == \
        _shapes(jp)
    want = np.asarray(jl.apply(jp, jnp.asarray(x), **kw))
    got = tl.apply(tp, torch.from_numpy(x), **kw).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    return got


def _x(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
@pytest.mark.parametrize("bias", [False, True])
def test_linear(activation, bias):
    kw = dict(bias=bias, activation=activation, stddev=0.5)
    y = _same((JL.Linear(13, 7, **kw), L.Linear(13, 7, **kw)), _x(5, 13))
    if activation == "relu":
        assert (y >= 0).all()


@pytest.mark.parametrize("stride,padding", [(1, 0), (1, 1), (2, 2)])
def test_conv2d(stride, padding):
    kw = dict(kernel_size=3, stride=stride, padding=padding,
              activation="relu")
    _same((JL.Conv2d(3, 4, **kw), L.Conv2d(3, 4, **kw)), _x(2, 3, 9, 9))


@pytest.mark.parametrize("k,s,p", [(2, 2, 0), (3, 2, 1), (3, 1, 2)])
@pytest.mark.parametrize("kind", ["MaxPool2d", "AvgPool2d"])
def test_pools_with_padding(kind, k, s, p):
    """The max pool pads with -inf, the average pool with zeros and
    divides by k² with the padding counted (layers.py:118-127)."""
    x = _x(2, 3, 7, 7)
    y = _same((getattr(JL, kind)(k, s, p), getattr(L, kind)(k, s, p)), x)
    if kind == "AvgPool2d" and p:
        # the corner window holds (k - p)² real cells of k²
        want = x[:, :, :k - p, :k - p].sum(axis=(2, 3)) / (k * k)
        np.testing.assert_allclose(y[:, :, 0, 0], want, rtol=1e-6,
                                   atol=1e-7)


def test_batchnorm_uses_the_biased_variance():
    x = 3.0 + 2.0 * _x(4, 3, 5, 5)
    z = _same((JL.BatchNorm(3), L.BatchNorm(3)), x)
    np.testing.assert_allclose(z.mean(axis=(0, 2, 3)), 0, atol=1e-5)
    np.testing.assert_allclose(z.var(axis=(0, 2, 3)), 1, atol=1e-3)


def test_cnn_sequence_matches_jax():
    """tests/test_layers.py's CNN, with padded pools."""
    def net(M):
        return M.Sequence(
            M.Conv2d(3, 8, kernel_size=3, stride=1, padding=1,
                     activation="relu"),
            M.BatchNorm(8),
            M.MaxPool2d(kernel_size=3, stride=2, padding=1),
            M.Conv2d(8, 4, kernel_size=3, stride=1, padding=1),
            M.AvgPool2d(kernel_size=2, stride=2),
            M.Reshape((2, -1)),
            M.Linear(4 * 8 * 8, 10, activation="gelu"))
    y = _same((net(JL), net(L)), _x(2, 3, 32, 32))
    assert y.shape == (2, 10)


def test_combinators_match_jax():
    def both(fn):
        return fn(JL), fn(L)
    x = _x(4, 6)
    _same(both(lambda M: M.ConcatenateLayers(
        [M.Linear(6, 2, bias=False), M.Linear(6, 3, activation="relu")])),
        x)
    y = _same(both(lambda M: M.SumLayers(
        [M.Identity(), M.Relu(), M.Gelu()])), x)
    np.testing.assert_allclose(
        y, x + np.maximum(x, 0) + np.asarray(jax.nn.gelu(x)), rtol=1e-6,
        atol=1e-6)
    jl, tl = both(lambda M: M.Concatenate(axis=1))
    got = tl.apply({}, [torch.from_numpy(x)] * 2).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jl.apply({}, [jnp.asarray(x)] * 2)))
    assert got.shape == (4, 12)


def test_sequence_of_linears_is_the_mlp_helper():
    """A Sequence of Linear layers reproduces the port's hand-written MLP
    (`models/base.mlp_apply`) on the same weights."""
    tower = L.Sequence(L.Linear(13, 32, bias=False, activation="relu"),
                       L.Linear(32, 32, bias=False, activation="relu"),
                       L.Linear(32, 1, bias=False))
    params = tower.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x(8, 13))
    ref = mlp_apply({f"W{i + 1}": p["W"] for i, p in enumerate(params)},
                    x, 3)
    assert torch.equal(tower.apply(params, x), ref)
    w = torch.cat([p["W"].reshape(-1) for p in params])
    assert abs(float(w.std()) - 0.01) < 1e-3      # stddev * N(0, 1)


def test_dropout_eval_identity_and_train_mask():
    x = torch.ones(200, 500)
    do = L.DropOut(0.3)
    assert do.apply({}, x) is x                  # eval: no rng needed
    with pytest.raises(AssertionError, match="rng"):
        do.apply({}, x, train=True)
    y1 = do.apply({}, x, rng=torch.Generator().manual_seed(3), train=True)
    y2 = do.apply({}, x, rng=torch.Generator().manual_seed(3), train=True)
    assert torch.equal(y1, y2)
    vals = set(np.unique(y1.numpy()).tolist())
    assert vals == {0.0, np.float32(1 / 0.7)}
    keep = float((y1 != 0).float().mean())
    assert abs(keep - 0.7) < 0.01                # 100,000 draws: 5 sigma
    # two DropOuts in one Sequence draw different masks
    seq = L.Sequence(L.DropOut(0.5), L.DropOut(0.0), L.DropOut(0.5))
    gen = torch.Generator().manual_seed(4)
    a = L.DropOut(0.5).apply({}, x, rng=gen, train=True)
    b = L.DropOut(0.5).apply({}, x, rng=gen, train=True)
    assert not torch.equal(a, b)
    z = seq.apply(seq.init(gen), x, rng=torch.Generator().manual_seed(4),
                  train=True)
    np.testing.assert_array_equal(z.numpy(), (a * b).numpy())


def test_layers_tower_trains():
    """A layers-built tower's params are plain tensors that autograd and an
    SGD step move, as the engine's towers are."""
    tower = L.Sequence(L.Linear(10, 32, activation="relu"),
                       L.DropOut(0.2), L.Linear(32, 1))
    params = tower.init(torch.Generator().manual_seed(0))
    flat = [t.requires_grad_() for p in params for t in p.values()]
    x, y = torch.from_numpy(_x(16, 10)), torch.from_numpy(_x(16, 1, seed=2))

    def loss():
        return ((tower.apply(params, x) - y) ** 2).mean()

    l0 = loss()
    l0.backward()
    with torch.no_grad():
        for t in flat:
            t -= 0.1 * t.grad
    assert float(loss().detach()) < float(l0.detach())
