"""herald_tpu_torch.serve and its checkpoint reader against herald_tpu's:
checkpoints written by either package serve the same in the port, round
trip bit-exactly, and the HTTP surface behaves as tests/test_serve.py pins
it for the JAX server. Probabilities agree within atol 1e-6 (bit-exact
gathers, f32 tower summed in another order)."""

import json
import threading
import urllib.request
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herald_tpu import HeraldConfig as JaxConfig
from herald_tpu.data import synthetic_ctr_data
from herald_tpu.models import get_model
from herald_tpu.serve import load_scorer as jax_load_scorer
from herald_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from herald_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from herald_tpu.train.engine import Engine as JaxEngine
from herald_tpu_torch import Engine, HeraldConfig
from herald_tpu_torch.bridge import state_from_numpy
from herald_tpu_torch.serve import Scorer, load_scorer, make_server
from herald_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

ROWS = 1200
B = 16


def _data(n, seed, model="wdl_criteo"):
    return synthetic_ctr_data(get_model(model).spec, n, seed=seed,
                              num_rows=ROWS)


def _jax_trained(tmp_path, table_dtype=np.float32, model="wdl_criteo", **kw):
    cfg = JaxConfig(model=model, batch_size=B, embedding_dim=8,
                    comm_mode="local", learning_rate=0.5,
                    table_dtype=table_dtype, **kw)
    eng = JaxEngine(cfg, table_rows=ROWS)
    dense, sparse, labels = _data(B * 6, seed=3, model=model)
    state, _ = eng.train_epoch(eng.init_state(0), dense, sparse, labels)
    ckpt = str(tmp_path / "ckpt")
    jax_save_checkpoint(state, ckpt)
    return cfg, eng, state, ckpt, dense, sparse


def _port_cfg(jcfg):
    return HeraldConfig.from_json(jcfg.to_json())


def _req(url, data=None):
    r = urllib.request.Request(
        url, data=None if data is None else json.dumps(data).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_jax_checkpoint_serves_like_jax_scorer(tmp_path):
    jcfg, _, _, ckpt, dense, sparse = _jax_trained(tmp_path)
    n = 2 * B + 5                    # two full batches + a padded tail
    want = jax_load_scorer(ckpt, jcfg, table_rows=ROWS).score(
        dense[:n], sparse[:n])
    scorer = load_scorer(ckpt, _port_cfg(jcfg), table_rows=ROWS,
                         device="cpu")
    got = scorer.score(dense[:n], sparse[:n])
    assert got.shape == (n,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert scorer.score(dense[:0], sparse[:0]).shape == (0,)


def test_jax_bf16_checkpoint_loads_bit_exact(tmp_path):
    jcfg, jeng, jst, ckpt, dense, sparse = _jax_trained(
        tmp_path, table_dtype=jnp.bfloat16)
    st = load_checkpoint(ckpt, "cpu", padded_rows=1200)
    assert st.table.dtype == torch.bfloat16
    np.testing.assert_array_equal(st.table.view(torch.int16).numpy(),
                                  np.asarray(jst.table).view(np.int16))
    for k, v in jst.dense.items():
        np.testing.assert_array_equal(st.dense[k].numpy(), np.asarray(v))
    assert int(st.step) == int(jst.step) == 6
    got = load_scorer(ckpt, _port_cfg(jcfg), table_rows=ROWS,
                      device="cpu").score(dense[:B], sparse[:B])
    want = np.asarray(jeng.predict(jst, dense[:B], sparse[:B]))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_jax_dfm_checkpoint_serves_jax_scores(tmp_path, dt):
    """A trained JAX DeepFM (table width 9, the FM term through K5's plain
    version here) serves the JAX scores. JAX cannot restore its own bf16
    checkpoint (ROADMAP queue 3), so there the reference is its predict
    on the trained state."""
    jcfg, jeng, jst, ckpt, dense, sparse = _jax_trained(
        tmp_path, table_dtype=jnp.bfloat16 if dt == "bf16" else np.float32,
        model="dfm_criteo")
    n = 2 * B + 5
    if dt == "f32":
        want = jax_load_scorer(ckpt, jcfg, table_rows=ROWS).score(
            dense[:n], sparse[:n])
    else:
        want = np.concatenate([
            np.asarray(jeng.predict(jst, *_padded(dense, sparse, i, n)))
            for i in range(0, n, B)])[:n]
    scorer = load_scorer(ckpt, _port_cfg(jcfg), table_rows=ROWS,
                         device="cpu")
    assert scorer.state.table.shape == (ROWS, 9)
    got = scorer.score(dense[:n], sparse[:n])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _padded(dense, sparse, i, n):
    """Rows [i, min(i + B, n)) padded to B by repeating the last, as the
    Scorer pads."""
    d, s = dense[i:min(i + B, n)], sparse[i:min(i + B, n)]
    pad = B - len(s)
    return (np.concatenate([d, np.repeat(d[-1:], pad, axis=0)]),
            np.concatenate([s, np.repeat(s[-1:], pad, axis=0)]))


def test_port_checkpoint_restores_bit_exact_in_jax(tmp_path):
    jcfg = JaxConfig(model="wdl_criteo", batch_size=B, embedding_dim=8)
    eng = Engine(_port_cfg(jcfg), table_rows=ROWS, device="cpu")
    st = eng.init_state(5)
    st = st._replace(step=torch.tensor(42, dtype=torch.int32))
    ckpt = str(tmp_path / "port")
    save_checkpoint(st, ckpt)
    jeng = JaxEngine(jcfg, table_rows=ROWS)
    back = jax_load_checkpoint(ckpt, jeng.init_state(0))
    np.testing.assert_array_equal(np.asarray(back.table), st.table.numpy())
    for k, v in st.dense.items():
        np.testing.assert_array_equal(np.asarray(back.dense[k]), v.numpy())
    assert int(back.step) == 42
    # the same files and manifest the JAX package writes for its state
    jax_save_checkpoint(back, str(tmp_path / "jax"))
    ours = json.load(open(tmp_path / "port" / "v42" / "manifest.json"))
    theirs = json.load(open(tmp_path / "jax" / "v42" / "manifest.json"))
    assert ours == theirs
    assert sorted(p.name for p in (tmp_path / "port" / "v42").iterdir()) \
        == sorted(p.name for p in (tmp_path / "jax" / "v42").iterdir())
    # and the port reads its own save back bit-exactly
    again = load_checkpoint(ckpt, "cpu")
    assert torch.equal(again.table, st.table) and int(again.step) == 42


def test_port_bf16_save_writes_jax_bit_patterns(tmp_path):
    jcfg, _, jst, jckpt, _, _ = _jax_trained(tmp_path,
                                             table_dtype=jnp.bfloat16)
    st = state_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    save_checkpoint(st, str(tmp_path / "port"))
    with np.load(tmp_path / "port" / "v6" / "replicated.npz") as ours, \
            np.load(tmp_path / "ckpt" / "v6" / "replicated.npz") as theirs:
        assert sorted(ours.files) == sorted(theirs.files)
        for k in theirs.files:
            assert ours[k].dtype == theirs[k].dtype, k
            assert ours[k].tobytes() == theirs[k].tobytes(), k
    assert json.load(open(tmp_path / "port" / "v6" / "manifest.json")) == \
        json.load(open(tmp_path / "ckpt" / "v6" / "manifest.json"))


def test_hybrid_checkpoint_remaps_to_one_device(tmp_path):
    """A table saved row-sharded over 8 devices (strided layout) serves
    on one device with the JAX hybrid engine's predictions."""
    jcfg = JaxConfig(model="wdl_criteo", batch_size=B, embedding_dim=8,
                     comm_mode="hybrid", learning_rate=0.5)
    jeng = JaxEngine(jcfg, table_rows=ROWS)
    dense, sparse, labels = _data(B * 8 * 2, seed=4)
    jst, _ = jeng.train_epoch(jeng.init_state(0), dense, sparse, labels)
    ckpt = str(tmp_path / "hyb")
    jax_save_checkpoint(jst, ckpt)
    want = np.asarray(jeng.predict(jst, dense[:B * 8], sparse[:B * 8]))
    got = load_scorer(ckpt, _port_cfg(jcfg), table_rows=ROWS,
                      device="cpu").score(
        dense[:B * 8], sparse[:B * 8])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _cached_run(tmp_path, overlay):
    from herald_tpu.train.cached import CachedEngine
    jcfg = JaxConfig(model="wdl_criteo", batch_size=B, embedding_dim=8,
                     comm_mode="local", learning_rate=0.5,
                     use_cache=True, use_scheduler=True,
                     cache_limit_ratio=0.4)
    eng = CachedEngine(jcfg, table_rows=ROWS)
    dense, sparse, labels = _data(B * 12, seed=5)
    pl = eng.make_planner(sparse, epochs=1, n_threads=1)
    if overlay:
        eng.enable_residency_tracking()
    st = eng.init_cached_state(0)
    # mid-stream (8 of 12 batches) for the overlay; the whole stream, then
    # sync_cache, for the plain save
    st, _ = eng.train_epoch_cached(st, pl, dense, sparse, labels,
                                   steps=8 if overlay else 12)
    ckpt = str(tmp_path / "cached")
    if overlay:
        # mid-stream save with the serve overlay sidecar
        ov = eng.serve_overlay(st)
        assert len(ov["rows"]) > 0
        jax_save_checkpoint(st, ckpt, extras={"serve_overlay": ov})
    else:
        st = eng.sync_cache(st, pl)
        jax_save_checkpoint(st, ckpt)
    pl.close()
    return jcfg, ckpt, dense, sparse


@pytest.mark.parametrize("overlay", [False, True],
                         ids=["synced", "serve_overlay"])
def test_cached_checkpoint_serves_like_jax(tmp_path, overlay):
    jcfg, ckpt, dense, sparse = _cached_run(tmp_path, overlay)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_load_scorer(ckpt, jcfg, table_rows=ROWS).score(
            dense[:3 * B], sparse[:3 * B])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        scorer = load_scorer(ckpt, _port_cfg(jcfg), table_rows=ROWS,
                             device="cpu")
    stale = [w for w in caught if "sync_cache" in str(w.message)]
    assert bool(stale) == (not overlay)
    got = scorer.score(dense[:3 * B], sparse[:3 * B])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_http_surface_matches_jax_server(tmp_path):
    jcfg, _, _, ckpt, dense, sparse = _jax_trained(tmp_path)
    scorer = load_scorer(ckpt, _port_cfg(jcfg), table_rows=ROWS,
                         device="cpu")
    assert isinstance(scorer, Scorer) and scorer.batch == B
    n = 2 * B + 5
    got = scorer.score(dense[:n], sparse[:n])
    srv = make_server(scorer, port=0)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        code, health = _req(f"http://127.0.0.1:{port}/health")
        assert code == 200 and health == {"status": "ok",
                                          "model": "wdl_criteo",
                                          "step": 6, "batch": B}
        code, resp = _req(f"http://127.0.0.1:{port}/score",
                          {"dense": dense[:n].tolist(),
                           "sparse": sparse[:n].tolist()})
        assert code == 200 and resp["n"] == n
        np.testing.assert_allclose(np.asarray(resp["probs"]), got,
                                   rtol=1e-5)
        assert all(0.0 <= p <= 1.0 for p in resp["probs"])

        # malformed requests -> 400, server stays up
        code, err = _req(f"http://127.0.0.1:{port}/score",
                         {"sparse": [[0, 1]]})          # wrong field count
        assert code == 400 and "error" in err
        code, err = _req(f"http://127.0.0.1:{port}/score",
                         {"dense": dense[:1].tolist(),
                          "sparse": (sparse[:1] + ROWS).tolist()})  # OOB id
        assert code == 400 and "out of range" in err["error"]
        code, err = _req(f"http://127.0.0.1:{port}/score",
                         {"dense": dense[:1].tolist(),
                          "sparse": (sparse[:1] * 0 - 1).tolist()})
        assert code == 400 and "out of range" in err["error"]
        code, _ = _req(f"http://127.0.0.1:{port}/nowhere")
        assert code == 404
        code, _ = _req(f"http://127.0.0.1:{port}/health")
        assert code == 200
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_width_mismatch_raises(tmp_path):
    jcfg, _, _, ckpt, _, _ = _jax_trained(tmp_path)
    cfg = _port_cfg(jcfg)
    cfg.embedding_dim = 16
    with pytest.raises(ValueError, match="does not fit"):
        load_scorer(ckpt, cfg, table_rows=ROWS, device="cpu")


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_serve_overlay_patches_rows_and_drops_out_of_range(dt):
    """A bf16 overlay sidecar reads back as raw V2 bit patterns; the
    port patches them as bf16 bits. Rows outside the table are dropped,
    as the JAX mode="drop" scatter does."""
    from herald_tpu_torch.train.checkpoint import apply_serve_overlay
    from herald_tpu_torch.train.engine import TrainState
    table = torch.zeros((10, 4), dtype=dt)
    rows = np.array([2, 7, 12])
    vals = jnp.asarray(np.arange(12, dtype=np.float32).reshape(3, 4) + 0.5,
                       jnp.bfloat16 if dt == torch.bfloat16 else np.float32)
    host = np.asarray(vals)
    if dt == torch.bfloat16:
        host = host.view(np.uint16).view(np.dtype("V2"))   # as np.load gives
    st = TrainState(table=table, table_slots={}, dense={}, dense_slots={},
                    step=torch.tensor(0, dtype=torch.int32))
    out = apply_serve_overlay(st, {"rows": rows, "values": host})
    want = torch.zeros((10, 4), dtype=dt)
    want[2] = torch.arange(4, dtype=torch.float32).to(dt) + 0.5
    want[7] = torch.arange(4, 8, dtype=torch.float32).to(dt) + 0.5
    assert torch.equal(out.table, want)
