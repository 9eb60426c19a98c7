"""The port's WDL towers against herald_tpu.models.wdl: logits from the
same (bridged) parameters agree within f32 rounding (rtol 1e-5, atol 1e-6:
the two frameworks sum the products in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herald_tpu.models import get_model as jax_get_model
from herald_tpu_torch.bridge import tensor_from_numpy
from herald_tpu_torch.models import available_models, bce_with_logits, get_model


@pytest.mark.parametrize("name", ["wdl_criteo", "wdl_avazu"])
def test_logits_match_jax(name):
    jm, tm = jax_get_model(name), get_model(name)
    assert tm.spec.num_sparse == jm.spec.num_sparse
    assert tm.table_rows == jm.table_rows
    D, B = 8, 16
    jp = jm.init_dense(jax.random.PRNGKey(0), D)
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    # the port's own init has the JAX shapes
    own = tm.init_dense(torch.Generator().manual_seed(0), D)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((B, jm.spec.num_sparse, D)).astype(np.float32)
    dense = rng.standard_normal((B, jm.spec.num_dense)).astype(np.float32)
    # weights 5x the 0.01 init: logits of order 1, so the relu gates and
    # the head all carry weight in the comparison
    tp = {k: v * 5 for k, v in tp.items()}
    jp = {k: v * 5 for k, v in jp.items()}
    want = np.asarray(jm.apply(jp, jnp.asarray(emb), jnp.asarray(dense)))
    got = tm.apply(tp, torch.from_numpy(emb), torch.from_numpy(dense))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_bce_matches_jax():
    from herald_tpu.models.base import bce_with_logits as jax_bce
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal(64) * 20).astype(np.float32)
    labels = rng.integers(0, 2, (64, 1)).astype(np.float32)
    want = float(jax_bce(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(bce_with_logits(torch.from_numpy(logits),
                                torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_registry_holds_only_ported_models():
    """Every model of the JAX package is ported: the port's registry is
    JAX's and its own multi-hot `dlrm_dcnv2_criteo1tb`, and a name neither
    has raises."""
    from herald_tpu.models import available_models as jax_available
    assert available_models() == sorted(jax_available()
                                        + ["dlrm_dcnv2_criteo1tb"])
    with pytest.raises(ValueError, match="unknown model.*wdl_criteo"):
        get_model("wdl_nowhere")
