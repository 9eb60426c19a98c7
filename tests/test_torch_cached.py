"""The port's scheduled, cached engine (`herald_tpu_torch/train/cached.py`)
against herald_tpu's `CachedEngine`: one bridged JAX state, and one
planner stream (each engine's own planner over the same ids, which the
planner makes identical: tests/test_torch_planner.py) or one plan tape,
fed into both (wdl_criteo, and dfm_criteo for its 9-wide rows; 2,000
rows, embedding 8, batch 32).

Tolerances:
- f32 table: per-step loss within 1e-6; cache (both planes), table, hot
  block and slots within 1e-5. The towers sum in another order (XLA
  against torch's CPU kernels), so values drift by f32 ulps.
- adagrad on the table: it divides each element's update by the root of
  its running squared gradient, so where that sum is tiny an f32 ulp of
  gradient becomes a larger step: table, cache and slots within 1e-4
  (measured max 3.4e-5, in 3 of 16,000 values); loss within 1e-6.
- bf16 table: the cache's value plane is `f32(bf16(emb - lr*g))`, so an
  f32 ulp of difference in `emb - lr*g` can round to the neighbouring
  bf16 value: the value plane, the table and the hot block within one
  bf16 ulp of the value (2^-8 relative, measured max 0); the delta plane
  (f32 sums of f32 grads) within 1e-5, the loss within 1e-5.
- The port against itself (epoch vs steps, index vs direct feed, the
  flush- and pull-free variants on vs off, resume vs uninterrupted):
  bit-exact.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herald_tpu import HeraldConfig as JaxConfig
from herald_tpu.data import synthetic_ctr_data
from herald_tpu.models import get_model
from herald_tpu.sched.replay import plan_cache as jax_plan_cache
from herald_tpu.train.cached import CachedEngine as JaxCachedEngine
from herald_tpu.train.checkpoint import save_checkpoint as jax_save
from herald_tpu_torch import Engine, HeraldConfig
from herald_tpu_torch.bridge import state_from_numpy, state_to_numpy
from herald_tpu_torch.ops.kernels import KERNELS
from herald_tpu_torch.sched.replay import ReplayPlanner
from herald_tpu_torch.train.cached import CachedEngine, CachedTrainState
from herald_tpu_torch.train.checkpoint import (apply_serve_overlay,
                                               load_cached_checkpoint,
                                               save_checkpoint)

ROWS, B = 2000, 32
_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _data(n, seed=6, rows=ROWS, hot=False):
    spec = get_model("wdl_criteo").spec
    d, s, y = synthetic_ctr_data(spec, n, seed=seed, num_rows=rows)
    if hot:
        # concentrate traffic on low ids so a pinned tier matters
        s = np.where(np.random.default_rng(seed).random(s.shape) < 0.5,
                     s % 64, s)
    return d, s, y


def _engines(rows=ROWS, **kw):
    base = dict(model="wdl_criteo", batch_size=B, embedding_dim=8,
                learning_rate=0.1)
    jcfg = JaxConfig(**{**base, **kw})
    jeng = JaxCachedEngine(jcfg, table_rows=rows)
    jst = jeng.init_cached_state(0)
    eng = CachedEngine(HeraldConfig.from_json(jcfg.to_json()),
                       table_rows=rows, device="cpu")
    st = state_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    assert isinstance(st, CachedTrainState)
    assert (eng.U_cap, eng.F_cap, eng.P_cap, eng.cache_rows,
            eng.pinned_rows) == (jeng.U_cap, jeng.F_cap, jeng.P_cap,
                                 jeng.cache_rows, jeng.pinned_rows)
    return jeng, jst, eng, st


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_state(st, jst, dt="f32", W=8, tol=1e-5):
    """The tolerances of the module docstring, leaf by leaf."""
    if dt == "f32":
        for a, b in ((st.cache, jst.cache), (st.table, jst.table),
                     (st.hot_table, jst.hot_table)):
            np.testing.assert_allclose(_f32(a), _f32(b), rtol=0, atol=tol)
    else:
        for a, b in ((st.cache[:, :W], jst.cache[:, :W]),
                     (st.table, jst.table), (st.hot_table, jst.hot_table)):
            a, b = _f32(a), _f32(b)
            assert (np.abs(a - b) <= 2.0 ** -8 * np.abs(b)).all()
        np.testing.assert_allclose(_f32(st.cache[:, W:]),
                                   _f32(jst.cache[:, W:]), rtol=0,
                                   atol=1e-5)
    for k in st.table_slots:
        np.testing.assert_allclose(_f32(st.table_slots[k]),
                                   _f32(jst.table_slots[k]), rtol=0,
                                   atol=tol)
    for k in st.hot_slots:
        np.testing.assert_allclose(_f32(st.hot_slots[k]),
                                   _f32(jst.hot_slots[k]), rtol=0,
                                   atol=tol)
    for k in st.dense:
        np.testing.assert_allclose(_f32(st.dense[k]), _f32(jst.dense[k]),
                                   rtol=0, atol=1e-5)
    assert int(st.step) == int(jst.step)


def _clone(st):
    """A copy of a port state that shares no memory with it (the engine
    updates the table, its slots and the cache in place)."""
    return jax.tree.map(lambda t: t.clone(), st)


def _equal_state(a, b):
    for x, y in zip(jax.tree.leaves(state_to_numpy(a)),
                    jax.tree.leaves(state_to_numpy(b))):
        np.testing.assert_array_equal(x, y)


# the cases of tests/test_cached.py and test_pinned.py: heavy eviction
# (the cache just above one batch's 832 unique slots), a cache the size of
# the table, and a pinned tier over concentrated ids
CASES = {
    "eviction": (dict(cache_limit=900), False),
    "big": (dict(cache_limit_ratio=1.0), False),
    "pinned": (dict(cache_limit_ratio=0.5, pinned_rows=64), True),
}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cached_steps_match_jax(case, dt):
    kw, hot = CASES[case]
    jeng, jst, eng, st = _engines(table_dtype=_DT[dt], **kw)
    d, s, y = _data(B * 8, hot=hot)
    jp = jeng.make_planner(s, epochs=1, n_threads=1)
    tp = eng.make_planner(s, epochs=1, n_threads=1)
    for i in range(jp.batch_num):
        jst, jstats = jeng.train_step_cached(jst, jp, d, s, y)
        st, stats = eng.train_step_cached(st, tp, d, s, y)
        tol = 1e-6 if dt == "f32" else 1e-5
        assert abs(float(stats["loss"]) - float(jstats["loss"])) <= tol, i
        assert int(stats["overflow"]) == int(jstats["overflow"]) == 0
    assert eng.train_step_cached(st, tp, d, s, y) == (st, None)
    _close_state(st, jst, dt)
    if case == "eviction":
        assert tp.perf()["miss_push"] > 0          # evictions happened
    jst = jeng.sync_cache(jst, jp)
    st = eng.sync_cache(st, tp)
    _close_state(st, jst, dt)
    if case == "pinned":
        # the hot block is written back into the table's rows [0, P)
        assert torch.equal(st.table[:64], st.hot_table)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_dfm_cached_steps_match_jax(dt):
    """DeepFM (dfm_criteo, width 9, the FM term through K5's plain
    versions) under heavy eviction, so every phase moves 9-wide rows."""
    jeng, jst, eng, st = _engines(table_dtype=_DT[dt], model="dfm_criteo",
                                  cache_limit=900)
    d, s, y = _data(B * 8)
    jp = jeng.make_planner(s, epochs=1, n_threads=1)
    tp = eng.make_planner(s, epochs=1, n_threads=1)
    for i in range(jp.batch_num):
        jst, jstats = jeng.train_step_cached(jst, jp, d, s, y)
        st, stats = eng.train_step_cached(st, tp, d, s, y)
        tol = 1e-6 if dt == "f32" else 1e-5
        assert abs(float(stats["loss"]) - float(jstats["loss"])) <= tol, i
    assert st.cache.shape[1] == 18 and tp.perf()["miss_push"] > 0
    _close_state(st, jst, dt, W=9)
    _close_state(eng.sync_cache(st, tp), jeng.sync_cache(jst, jp), dt, W=9)


def test_pinned_adagrad_matches_jax():
    """A pinned tier with adagrad on the table (tests/test_cached.py:
    289-330 on one device): slots ride the flush, the hot block takes
    adagrad through its own f32 slots."""
    jeng, jst, eng, st = _engines(
        embed_optimizer="adagrad", embed_learning_rate=0.5,
        cache_limit_ratio=0.5, pinned_rows=16)
    d, s, y = _data(B * 8, hot=True, seed=17)
    jp = jeng.make_planner(s, epochs=2, n_threads=1)
    tp = eng.make_planner(s, epochs=2, n_threads=1)
    slots0 = {k: v.clone() for k, v in st.table_slots.items()}
    while True:
        jst2, jstats = jeng.train_epoch_cached(jst, jp, d, s, y, steps=5)
        st2, stats = eng.train_epoch_cached(st, tp, d, s, y, steps=5)
        if stats is None:
            assert jstats is None
            break
        jst, st = jst2, st2
        np.testing.assert_allclose(stats["loss"].numpy(),
                                   np.asarray(jstats["loss"]), rtol=0,
                                   atol=1e-6)
    _close_state(st, jst, tol=1e-4)
    jst = jeng.sync_cache(jst, jp)
    st = eng.sync_cache(st, tp)
    _close_state(st, jst, tol=1e-4)
    for k in slots0:
        assert (st.table_slots[k] != slots0[k]).any()
    assert all(bool(v.abs().max() > 0) for v in st.hot_slots.values())
    assert set(st.hot_slots) == {"accum"}
    assert st.hot_slots["accum"].dtype == torch.float32


def test_epoch_equals_steps_and_index_feed_equals_direct_feed():
    d, s, y = _data(B * 6, seed=9)
    cfg = dict(cache_limit=900)

    def run(mode):
        _, _, eng, st = _engines(**cfg)
        pl = eng.make_planner(s, epochs=1, n_threads=1)
        losses = []
        if mode == "steps":
            for _ in range(pl.batch_num):
                st, stats = eng.train_step_cached(st, pl, d, s, y)
                losses.append(stats["loss"])
        elif mode == "epoch":
            st, stats = eng.train_epoch_cached(st, pl, d, s, y,
                                               steps=pl.batch_num)
            losses = list(stats["loss"])
        elif mode == "index":
            dev = eng.stage_dataset(d, s, y)
            for _ in range(2):
                st, stats = eng.train_epoch_cached(st, pl, None, None, None,
                                                   steps=3, device_data=dev)
                losses += list(stats["loss"])
        else:       # every chunk staged ahead, direct feed
            for chunk in eng.stage_program_chunks(pl, 4, raw=(d, s, y)):
                st, stats = eng.train_epoch_staged(st, chunk)
                losses += list(stats["loss"])
        st = eng.sync_cache(st, pl)
        return torch.stack(losses), st

    ref_loss, ref = run("steps")
    for mode in ("epoch", "index", "staged"):
        loss, st = run(mode)
        assert torch.equal(loss, ref_loss), mode
        _equal_state(st, ref)


def test_flush_and_pull_free_counters_match_jax_and_are_exact():
    """tests/test_nopull.py's solo big-cache run over two epochs: the
    chunks that take the flush-free and pull-free variants are the same
    as JAX's, and the port's result with the variants off is the same to
    the bit."""
    d, s, y = _data(16 * 12, seed=5, rows=1500)

    def run(on, jax_too=False):
        kw = dict(batch_size=16, learning_rate=0.5, cache_limit_ratio=1.0,
                  sched_noflush_variant=on, sched_nopull_variant=on)
        jeng, jst, eng, st = _engines(rows=1500, **kw)
        tp = eng.make_planner(s, epochs=2, n_threads=1)
        jp = jeng.make_planner(s, epochs=2, n_threads=1)
        for _ in range(6):
            st, _ = eng.train_epoch_cached(st, tp, d, s, y, steps=4)
            if jax_too:
                jst, _ = jeng.train_epoch_cached(jst, jp, d, s, y, steps=4)
        assert (eng.noflush_chunks, eng.nopull_chunks) == \
            ((jeng.noflush_chunks, jeng.nopull_chunks) if jax_too
             else (0, 0) if not on else (6, 3))
        return eng.sync_cache(st, tp)

    on = run(True, jax_too=True)
    off = run(False)
    _equal_state(on, off)


def test_sync_then_evaluate_matches_jax_auc():
    jeng, jst, eng, st = _engines(cache_limit=900, learning_rate=2.0)
    d, s, y = _data(B * 8, seed=8)
    jp = jeng.make_planner(s, epochs=3, n_threads=1)
    tp = eng.make_planner(s, epochs=3, n_threads=1)
    for _ in range(4):
        jst, _ = jeng.train_epoch_cached(jst, jp, d, s, y, steps=6)
        st, _ = eng.train_epoch_cached(st, tp, d, s, y, steps=6)
    with pytest.warns(UserWarning, match="sync_cache"):
        eng.evaluate(st, d, s, y)
    jst = jeng.sync_cache(jst, jp)
    st = eng.sync_cache(st, tp)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = eng.evaluate(st, d, s, y)
        probs = eng.predict(st, d[:B], s[:B])
    want = jeng.evaluate(jst, d, s, y)
    assert abs(got["auc"] - want["auc"]) <= 1e-6
    assert got["auc"] > 0.6
    np.testing.assert_allclose(
        probs.numpy(), np.asarray(jeng.predict(jst, d[:B], s[:B])),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_serve_overlay_matches_jax(opt):
    """The overlay (synced values of every dirty cached row) covers the
    same rows as JAX's, within the f32 tolerance; applied onto the base
    view it equals the port's own sync_cache bit for bit
    (tests/test_serve_view.py:77-127)."""
    # the table's optimizer is `opt`; the tower keeps SGD, whose steps do
    # not amplify f32 ulps the way adagrad's divisions do at this lr
    jeng, jst, eng, st = _engines(rows=4000, batch_size=16,
                                  embed_optimizer=opt,
                                  learning_rate=0.1, cache_limit_ratio=0.15,
                                  pinned_rows=8)
    d, s, y = _data(16 * 24, seed=3, rows=4000)
    jp = jeng.make_planner(s, epochs=1, n_threads=1)
    tp = eng.make_planner(s, epochs=1, n_threads=1)
    jeng.enable_residency_tracking()
    eng.enable_residency_tracking()
    for _ in range(5):              # 24 steps: the stream drains
        jst, _ = jeng.train_epoch_cached(jst, jp, d, s, y, steps=5)
        st, _ = eng.train_epoch_cached(st, tp, d, s, y, steps=5)
    want = jeng.serve_overlay(jst)
    got = eng.serve_overlay(st)
    assert len(got["rows"]) > 0
    np.testing.assert_array_equal(got["mirror"], want["mirror"])
    np.testing.assert_array_equal(got["rows"], want["rows"])
    np.testing.assert_array_equal(got["hot_rows"], want["hot_rows"])
    for k in want:
        if k not in ("mirror", "rows", "hot_rows"):
            np.testing.assert_allclose(got[k].astype(np.float32),
                                       want[k].astype(np.float32), rtol=0,
                                       atol=1e-4 if opt == "adagrad"
                                       else 1e-5, err_msg=k)
    base = CachedEngine.to_base_state(_clone(st))
    patched = apply_serve_overlay(base, got)
    synced = eng.sync_cache(st, tp)
    assert torch.equal(patched.table, synced.table)
    for k in patched.table_slots:
        assert torch.equal(patched.table_slots[k], synced.table_slots[k])


def test_pinned_cached_matches_plain_engine():
    """tests/test_pinned.py:83-122 on the port: one worker, so the cache is
    always fresh and cached SGD with a pinned tier is exact SGD."""
    d, s, y = _data(16 * 12, seed=3, rows=4096, hot=True)
    lr = 0.5
    plain = Engine(HeraldConfig(model="wdl_criteo", batch_size=16,
                                embedding_dim=8, learning_rate=lr),
                   table_rows=4096, device="cpu")
    ps = plain.init_state(0)
    eng = CachedEngine(HeraldConfig(model="wdl_criteo", batch_size=16,
                                    embedding_dim=8, learning_rate=lr,
                                    cache_limit_ratio=0.5, pinned_rows=64),
                       table_rows=4096, device="cpu")
    st = eng.init_cached_state(0)
    # one starting table for both engines (hot block = table rows [0, P))
    st.table.copy_(ps.table)
    st = st._replace(hot_table=st.table[:64].clone(),
                     dense={k: v.clone() for k, v in ps.dense.items()})
    for i in range(12):
        sl = slice(i * 16, (i + 1) * 16)
        ps, _ = plain.train_step(ps, d[sl], s[sl], y[sl])
    pl = eng.make_planner(s, epochs=1, n_threads=1)
    while True:
        st2, stats = eng.train_step_cached(st, pl, d, s, y)
        if stats is None:
            break
        st = st2
    st = eng.sync_cache(st, pl)
    np.testing.assert_allclose(st.table[:64].numpy(),
                               st.hot_table.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(st.table.numpy(), ps.table.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_jax_midstream_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX cached checkpoint written mid-stream (cache arrays, hot block
    and its slots beside the base leaves) loads in the port, the port's
    planner fast-forwards to its step, and training goes on as in JAX."""
    kw = dict(cache_limit=900, pinned_rows=32, embed_optimizer="adagrad",
              embed_learning_rate=0.3)
    jeng, jst, eng, _ = _engines(**kw)
    d, s, y = _data(B * 10, seed=12, hot=True)
    jp = jeng.make_planner(s, epochs=1, n_threads=1)
    jst, _ = jeng.train_epoch_cached(jst, jp, d, s, y, steps=4)
    jax_save(jst, str(tmp_path / "ck"))
    st = load_cached_checkpoint(str(tmp_path / "ck"), "cpu")
    assert int(st.step) == 4 and set(st.hot_slots) == {"accum"}
    _close_state(st, jst, tol=0)
    tp = eng.make_planner(s, epochs=1, n_threads=1)
    assert tp.fast_forward(int(st.step)) == 4
    jst, jstats = jeng.train_epoch_cached(jst, jp, d, s, y, steps=6)
    st, stats = eng.train_epoch_cached(st, tp, d, s, y, steps=6)
    np.testing.assert_allclose(stats["loss"].numpy(),
                               np.asarray(jstats["loss"]), rtol=0,
                               atol=1e-6)
    _close_state(eng.sync_cache(st, tp), jeng.sync_cache(jst, jp),
                 tol=1e-4)


def test_port_checkpoint_roundtrip_and_resume_is_bit_exact(tmp_path):
    """The port saves a whole CachedTrainState in the JAX layout (bf16
    table included) and a resumed run equals the uninterrupted one."""
    d, s, y = _data(B * 10, seed=13, hot=True)
    kw = dict(cache_limit=900, pinned_rows=32, table_dtype=jnp.bfloat16)
    _, _, eng, st0 = _engines(**kw)
    pl = eng.make_planner(s, epochs=1, n_threads=1)
    full, _ = eng.train_epoch_cached(
        _clone(st0), pl, d, s, y, steps=10)
    full = eng.sync_cache(full, pl)

    pl = eng.make_planner(s, epochs=1, n_threads=1)
    st, _ = eng.train_epoch_cached(st0, pl, d, s, y, steps=4)
    save_checkpoint(st, str(tmp_path / "ck"))
    back = load_cached_checkpoint(str(tmp_path / "ck"), "cpu")
    _equal_state(back, st)
    assert back.table.dtype == torch.bfloat16
    pl = eng.make_planner(s, epochs=1, n_threads=1)
    assert pl.fast_forward(4) == 4
    back, _ = eng.train_epoch_cached(back, pl, d, s, y, steps=6)
    _equal_state(eng.sync_cache(back, pl), full)


def test_tape_fed_run_equals_live_run_and_launches_nothing_on_the_cpu(
        tmp_path):
    """A JAX-recorded plan tape drives the port's engine exactly as the
    live planner does; on the CPU no kernel launch is counted."""
    d, s, y = _data(B * 6, seed=14)
    jeng, _, eng, st = _engines(cache_limit=900)
    jax_plan_cache(jeng, s, str(tmp_path / "tape"), epochs=1, n_threads=1)
    before = {k: f.launches for k, f in KERNELS.items()}
    live = eng.make_planner(s, epochs=1, n_threads=1)
    a, _ = eng.train_epoch_cached(_clone(st), live, d, s, y, steps=6)
    rp = ReplayPlanner(str(tmp_path / "tape"))
    b, _ = eng.train_epoch_cached(st, rp, d, s, y, steps=6)
    _equal_state(eng.sync_cache(a, live), eng.sync_cache(b, rp))
    assert {k: f.launches for k, f in KERNELS.items()} == before


def test_cached_engine_refuses_to_run_without_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = HeraldConfig(model="wdl_criteo", batch_size=B, embedding_dim=8,
                       cache_limit=900)
    with pytest.raises(RuntimeError, match="CUDA"):
        CachedEngine(cfg, table_rows=ROWS)
