"""The port's Engine (local mode) against herald_tpu's: a JAX state trained
for a few steps, bridged through numpy, scores the same.

Tolerances: probabilities within atol 1e-6 (the gather is bit-exact; the
f32 tower sums in another order). AUC and accuracy within 1e-4: a
probability that moves by 1e-7 can flip a near-tie in the ranking.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herald_tpu import HeraldConfig as JaxConfig
from herald_tpu.data import synthetic_ctr_data
from herald_tpu.models import get_model
from herald_tpu.train.engine import Engine as JaxEngine
from herald_tpu_torch import Engine, HeraldConfig
from herald_tpu_torch.bridge import state_from_numpy
from herald_tpu_torch.ops.kernels import embedding_gather

ROWS = 1203          # not a multiple of 8: the table pads to 1208
B = 16

_DT = {"f32": (np.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _trained(dt, pallas):
    jdt, tdt = _DT[dt]
    jcfg = JaxConfig(model="wdl_criteo", batch_size=B, embedding_dim=8,
                     learning_rate=0.5, table_dtype=jdt,
                     use_pallas_gather=pallas)
    spec = get_model("wdl_criteo").spec
    dense, sparse, labels = synthetic_ctr_data(spec, B * 9 + 5, seed=11,
                                               num_rows=ROWS)
    jeng = JaxEngine(jcfg, table_rows=ROWS)
    jst, _ = jeng.train_epoch(jeng.init_state(0), dense, sparse, labels)
    cfg = HeraldConfig.from_json(jcfg.to_json())
    assert cfg.table_dtype == tdt
    eng = Engine(cfg, table_rows=ROWS, device="cpu")
    st = state_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    return jeng, jst, eng, st, (dense, sparse, labels)


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_predict_and_evaluate_match_jax(dt, pallas):
    jeng, jst, eng, st, (dense, sparse, labels) = _trained(dt, pallas)
    assert eng.padded_rows == jeng.exchange.padded_rows == 1208
    assert st.table.dtype == _DT[dt][1] and int(st.step) == 9
    np.testing.assert_array_equal(
        st.table.view(torch.int16 if dt == "bf16" else torch.int32).numpy(),
        np.asarray(jst.table).view(np.int16 if dt == "bf16" else np.int32))

    before = embedding_gather.launches
    for i in range(3):
        d, s = dense[i * B:(i + 1) * B], sparse[i * B:(i + 1) * B]
        want = np.asarray(jeng.predict(jst, d, s))
        got = eng.predict(st, d, s)
        assert got.dtype == torch.float32 and got.shape == (B,)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert embedding_gather.launches == before     # CPU: plain version

    # a tail that pads (149 = 9 batches + 5), and blocks of T batches
    for n, batch in ((len(sparse), None), (100, 8)):
        want = jeng.evaluate(jst, dense[:n], sparse[:n], labels[:n],
                             batch=batch)
        got = eng.evaluate(st, dense[:n], sparse[:n], labels[:n],
                           batch=batch)
        assert abs(got["auc"] - want["auc"]) <= 1e-4
        assert abs(got["acc"] - want["acc"]) <= 1e-4
    assert eng.evaluate(st, dense[:0], sparse[:0], labels[:0])["auc"] == 0.5


def test_init_state_is_seeded_and_in_table_dtype():
    cfg = HeraldConfig(model="wdl_criteo", batch_size=B, embedding_dim=8,
                       table_dtype=torch.bfloat16)
    eng = Engine(cfg, table_rows=ROWS, device="cpu")
    a, b = eng.init_state(3), eng.init_state(3)
    assert a.table.dtype == torch.bfloat16 and a.table.shape == (1208, 8)
    assert torch.equal(a.table, b.table)
    assert all(torch.equal(a.dense[k], b.dense[k]) for k in a.dense)
    assert not torch.equal(a.table, eng.init_state(4).table)
    assert 0.005 < float(a.table.float().std()) < 0.015
    assert int(a.step) == 0 and a.step.dtype == torch.int32


def test_hybrid_at_world_size_one_is_the_local_engine(monkeypatch):
    """With no process group and no torch.distributed.run environment,
    `comm_mode="hybrid"` is one rank: the local engine, as JAX's hybrid
    engine on a one-device mesh is, bit for bit from one seed (the SGD
    fast path and CUDA graphs included)."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    spec = get_model("wdl_criteo").spec
    dense, sparse, labels = synthetic_ctr_data(spec, B * 6, seed=2,
                                               num_rows=ROWS)
    for opt in ("sgd", "adam"):
        engines = [Engine(HeraldConfig(model="wdl_criteo", batch_size=B,
                                       embedding_dim=8, optimizer=opt,
                                       learning_rate=0.1, comm_mode=mode),
                          table_rows=ROWS, device="cpu")
                   for mode in ("local", "hybrid")]
        assert engines[1].num_shards == 1 and engines[1].comm.backend is None
        assert engines[1]._fast_local_sgd == (opt == "sgd")
        assert engines[1].exchange == engines[0].exchange
        out = []
        for eng in engines:
            st, stats = eng.train_epoch(eng.init_state(3), dense, sparse,
                                        labels)
            out.append((st, stats["loss"], eng.predict(st, dense[:B],
                                                       sparse[:B])))
        (a, la, pa), (b, lb, pb) = out
        assert torch.equal(la, lb) and torch.equal(pa, pb)
        assert torch.equal(a.table, b.table)
        assert all(torch.equal(a.dense[k], b.dense[k]) for k in a.dense)
