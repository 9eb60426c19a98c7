"""Every model of the port against herald_tpu.models: the registry, the
init shapes, `default_lr` and `train_engine`, and from the same (bridged)
parameters the logits and the gradients of the BCE loss with respect to
the dense parameters and `emb`; then the mirror of tests/test_models.py on
the port's engine (embedding 8, 2,000 rows, batch 32, on the CPU), and
every model's checkpoint across the packages both ways, bit for bit.

Weights are 5x their init so that logits are of order 1 or more and every
relu gate carries weight. Tolerances: logits and loss rtol 1e-5, atol
2e-6 * max|logit|: the frameworks sum the products in other orders, and
a float32 sum's error grows with the size of its terms, so a logit near
zero keeps the error of the largest ones (wdl_adult: logits up to 47.8
from an 829-wide wide part, the port and JAX each within 2e-5 of a
float64 evaluation and 1.7e-5 apart). Both packages are also held to a
float64 evaluation of the port's `apply` on the same inputs, with the
same tolerance, so that it bounds each one's error and not only their
distance. Gradients rtol 1e-4, atol 1e-5 * max|grad| of that tensor: a
gradient passes the same sums back through up to 10 matrix products
(dc_criteo), and elements that cancel to near zero keep the absolute
error of the tensor's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herald_tpu import HeraldConfig as JaxConfig
from herald_tpu.models import available_models as jax_available_models
from herald_tpu.models import get_model as jax_get_model
from herald_tpu.models.base import bce_with_logits as jax_bce
from herald_tpu.train.checkpoint import load_checkpoint as jax_load
from herald_tpu.train.checkpoint import save_checkpoint as jax_save
from herald_tpu.train.engine import Engine as JaxEngine
from herald_tpu_torch import Engine, HeraldConfig
from herald_tpu_torch.bridge import tensor_from_numpy
from herald_tpu_torch.data import synthetic_ctr_data
from herald_tpu_torch.models import (available_models, bce_with_logits,
                                     get_model)
from herald_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

NAMES = jax_available_models()
# the models of the port's own (`models/dlrm.py`), which JAX has not
PORT_ONLY = ["dlrm_dcnv2_criteo1tb"]
D, B = 8, 16


def test_registry_equals_jax():
    """JAX's 21 models, and the port's own multi-hot model beside them."""
    assert available_models() == sorted(NAMES + PORT_ONLY)
    assert len(NAMES) == 21
    for name in NAMES:
        jm, tm = jax_get_model(name), get_model(name)
        assert tm.name == name
        assert tm.default_lr == jm.default_lr, name
        assert tm.train_engine == jm.train_engine, name
        assert tm.table_rows == jm.table_rows, name
        assert tm.spec.num_sparse == jm.spec.num_sparse
        assert tm.spec.num_dense == jm.spec.num_dense
        for d in (1, 8, 512):
            assert tm.emb_width(d) == jm.emb_width(d), (name, d)
    assert [n for n in NAMES if get_model(n).train_engine == "fae"] == [
        "fae_dcn_criteosearch", "fae_dfm_avazu", "fae_ncf_movie",
        "fae_wdl_criteo"]


def _inputs(name, seed=1):
    jm = jax_get_model(name)
    jp = {k: np.asarray(v) * 5
          for k, v in jm.init_dense(jax.random.PRNGKey(0), D).items()}
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((B, jm.spec.num_sparse, jm.emb_width(D))
                              ).astype(np.float32)
    dense = rng.standard_normal((B, jm.spec.num_dense)).astype(np.float32)
    labels = rng.integers(0, 2, (B, 1)).astype(np.float32)
    return jm, jp, emb, dense, labels


@pytest.mark.parametrize("name", NAMES)
def test_init_shapes_match_jax(name):
    jm, jp, _, _, _ = _inputs(name)
    own = get_model(name).init_dense(torch.Generator().manual_seed(0), D)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in jp.items()}
    assert all(v.dtype == torch.float32 for v in own.values())


def _close(got, want, rtol, scale_atol):
    atol = scale_atol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", NAMES)
def test_logits_and_grads_match_jax(name):
    jm, jp, emb, dense, labels = _inputs(name)
    tm = get_model(name)

    def jloss(params, e):
        return jax_bce(jm.apply(params, e, jnp.asarray(dense)),
                       jnp.asarray(labels))

    jparams = {k: jnp.asarray(v) for k, v in jp.items()}
    want = np.asarray(jm.apply(jparams, jnp.asarray(emb),
                               jnp.asarray(dense)))
    want_loss, (want_gp, want_ge) = jax.value_and_grad(
        jloss, argnums=(0, 1))(jparams, jnp.asarray(emb))

    params = {k: tensor_from_numpy(v).requires_grad_(True)
              for k, v in jp.items()}
    e = torch.from_numpy(emb).requires_grad_(True)
    logits = tm.apply(params, e, torch.from_numpy(dense))
    assert logits.shape == (B,) and logits.dtype == torch.float32
    with torch.no_grad():
        exact = tm.apply({k: torch.from_numpy(np.asarray(v, np.float64))
                          for k, v in jp.items()},
                         torch.from_numpy(emb).double(),
                         torch.from_numpy(dense).double())
        exact_loss = float(bce_with_logits(
            exact, torch.from_numpy(labels).double()))
    exact = exact.numpy()
    assert exact.dtype == np.float64
    scale = 2e-6 * float(np.abs(exact).max())
    got = logits.detach().numpy()
    for a, b in ((got, want), (got, exact), (want, exact)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=scale)
    loss = bce_with_logits(logits, torch.from_numpy(labels))
    for a, b in ((float(loss.detach()), float(want_loss)),
                 (float(loss.detach()), exact_loss),
                 (float(want_loss), exact_loss)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=scale)
    grads = torch.autograd.grad(loss, [*params.values(), e])
    for k, g in zip(params, grads[:-1]):
        _close(g.numpy(), np.asarray(want_gp[k]), 1e-4, 1e-5)
    _close(grads[-1].numpy(), np.asarray(want_ge), 1e-4, 1e-5)


@pytest.mark.parametrize(
    "name", [n for n in NAMES if jax_get_model(n).train_engine == "engine"])
def test_model_trains_one_epoch(name):
    """tests/test_models.py on the port's engine: one epoch of finite
    losses, then predictions in [0, 1]."""
    model = get_model(name)
    cfg = HeraldConfig(model=name, batch_size=32, embedding_dim=D,
                       learning_rate=model.default_lr)
    eng = Engine(cfg, table_rows=2000, device="cpu")
    dense, sparse, labels = synthetic_ctr_data(model.spec, 512, seed=2,
                                               num_rows=2000)
    state, stats = eng.train_epoch(eng.init_state(0), dense, sparse, labels)
    assert stats["loss"].shape == (16,)
    assert bool(torch.isfinite(stats["loss"]).all()), name
    preds = eng.predict(state, dense[:32], sparse[:32])
    assert preds.shape == (32,)
    assert bool(((preds >= 0) & (preds <= 1)).all())


@pytest.mark.parametrize("name", NAMES)
def test_checkpoints_interchange_with_jax(name, tmp_path):
    """A port checkpoint of every model restores in the JAX package bit for
    bit, and the JAX package's save of that state loads back in the port
    as it was."""
    jcfg = JaxConfig(model=name, batch_size=8, embedding_dim=D)
    eng = Engine(HeraldConfig.from_json(jcfg.to_json()), table_rows=400,
                 device="cpu")
    st = eng.init_state(3)
    save_checkpoint(st, str(tmp_path / "port"))
    back = jax_load(str(tmp_path / "port"),
                    JaxEngine(jcfg, table_rows=400).init_state(0))
    np.testing.assert_array_equal(np.asarray(back.table), st.table.numpy())
    assert set(back.dense) == set(st.dense)
    for k, v in st.dense.items():
        np.testing.assert_array_equal(np.asarray(back.dense[k]), v.numpy())
    jax_save(back, str(tmp_path / "jax"))
    again = load_checkpoint(str(tmp_path / "jax"), "cpu")
    assert torch.equal(again.table, st.table)
    assert all(torch.equal(again.dense[k], v) for k, v in st.dense.items())
