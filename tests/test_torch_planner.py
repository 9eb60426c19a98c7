"""The port's host planner (`herald_tpu_torch/sched/`) against the JAX
package's: the same C++ sources built by each package's own loader, bound
by each package's own ctypes signatures, must give the same programs,
array for array, on the same ids. Also the pinned-tier contract of
tests/test_pinned.py:36-80, the traffic sizing and its sweeps, and plan
tapes that cross between the packages.

Everything here is host code and integers: every comparison is exact.
"""

import os

import numpy as np
import pytest

from herald_tpu import HeraldConfig as JaxConfig
from herald_tpu.data import synthetic_ctr_data
from herald_tpu.models import get_model
from herald_tpu.sched import replay as jax_replay
from herald_tpu.sched import sizing as jax_sizing
from herald_tpu.sched.planner import CachePlanner as JaxPlanner
from herald_tpu.train.cached import CachedEngine as JaxCachedEngine
from herald_tpu_torch import HeraldConfig
from herald_tpu_torch.sched import build, replay, sizing
from herald_tpu_torch.sched.planner import CachePlanner
from herald_tpu_torch.train.cached import CachedEngine

ROWS, MBS = 1500, 8


def _ids(n=4 * MBS * 12, seed=7):
    spec = get_model("wdl_criteo").spec
    _, sparse, _ = synthetic_ctr_data(spec, n, seed=seed, num_rows=ROWS)
    # concentrate traffic on low ids so pinned rows and reuse matter
    rng = np.random.default_rng(seed)
    return np.where(rng.random(sparse.shape) < 0.4, sparse % 48, sparse)


# one planner configuration per case: nrank 4 over 4 owner shards, so the
# flush and pull routing (owner buckets, hoisting) is exercised
CASES = {
    "lru": dict(cache_rows=300),
    "lfu": dict(cache_rows=300, policy="lfu"),
    "lfuopt": dict(cache_rows=300, policy="lfuopt", bound=1),
    "pinned": dict(cache_rows=300, pinned_rows=32),
    "hoisting": dict(cache_rows=400, pull_target=20, hoist_window=4,
                     prefetch_cap=64, owner_cap=12, bound=2),
    "tight": dict(cache_rows=220, unique_cap=216, flush_cap=208,
                  owner_cap=6, shuffle_seed=3),
}


def _pair(case, ids, epochs=2):
    kw = dict(nrank=4, batch_size=MBS, num_shards=4,
              rows_per_shard=-(-ROWS // 4), epochs=epochs, n_threads=2,
              **CASES[case])
    return JaxPlanner(ids, **kw), CachePlanner(ids, **kw)


def _same_program(a, b):
    for f in ("assign", "slots", "pulls", "flush_ids", "flush_slots",
              "prefetch_ids", "prefetch_slots", "uniq", "inv"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


def test_planner_library_is_the_ports_own_build():
    path = build.planner_lib_path()
    assert os.path.dirname(path) == str(build.BUILD_DIR)
    assert os.path.basename(path).startswith("libherald_planner.")
    tag, value = build.abi_hash()
    assert tag in os.path.basename(path)
    assert build._lib_abi(build.BUILD_DIR / os.path.basename(path)) == value
    # the JAX package's own library is never the one loaded
    assert "herald_tpu/sched" not in path


def test_planner_build_failure_raises_with_the_compiler_output(
        tmp_path, monkeypatch):
    (tmp_path / build.SOURCE).write_text("int broken(\n")
    (tmp_path / "herald_common.h").write_text("")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="planner build failed") as e:
        build.planner_lib_path()
    assert "error" in str(e.value)
    assert not list((tmp_path / "_build").glob("*.so"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_programs_match_jax_planner(case):
    ids = _ids()
    jp, tp = _pair(case, ids)
    assert (jp.batch_num, jp.U_cap, jp.F_cap, jp.P_cap) == \
        (tp.batch_num, tp.U_cap, tp.F_cap, tp.P_cap)
    # a few single pops, then chunks of uneven size, then fast-forward
    for _ in range(3):
        _same_program(jp.pop(), tp.pop())
    for steps in (5, 7):
        a, b = jp.pop_chunk(steps), tp.pop_chunk(steps)
        assert a[0] == b[0] == steps
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x[:steps], y[:steps])
    assert jp.fast_forward(4) == tp.fast_forward(4) == 4
    _same_program(jp.pop(), tp.pop())
    # (mid-stream counters depend on how far the planning thread ran
    # ahead; they are compared once the stream is drained)
    # drain: the end-of-stream chunk, then the dirty dump
    while True:
        a, b = jp.pop_chunk(16), tp.pop_chunk(16)
        assert a[0] == b[0]
        if a[0] == 0:
            break
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x[:a[0]], y[:a[0]])
    assert jp.pop() is None and tp.pop() is None
    assert jp.perf() == tp.perf()
    if case == "hoisting":
        assert tp.perf()["hoisted_pull"] > 0, "hoisting never fired"
    if case == "tight":
        assert tp.perf()["deferred_flush"] > 0, "budget never bound"
    for z in range(4):
        for x, y in zip(jp.dirty_rows(z), tp.dirty_rows(z)):
            np.testing.assert_array_equal(x, y)
    assert tp.queue_length() == 0
    assert tp.iter_time_us() >= 0
    assert set(tp.phase_times_us()) == {"score", "assign", "plan", "stale"}
    jp.close()
    tp.close()


def test_dirty_rows_refuses_an_undrained_stream():
    _, tp = _pair("lru", _ids())
    tp.pop()
    with pytest.raises(RuntimeError, match="drain"):
        tp.dirty_rows(0)
    tp.close()


def test_caps_are_enforced_like_jax():
    ids = _ids()
    with pytest.raises(ValueError, match="cache_rows"):
        CachePlanner(ids, nrank=1, batch_size=MBS, cache_rows=10,
                     num_shards=1, rows_per_shard=ROWS)
    tp = CachePlanner(ids, nrank=1, batch_size=MBS, cache_rows=400,
                      num_shards=1, rows_per_shard=ROWS, unique_cap=40,
                      n_threads=1)
    with pytest.raises(RuntimeError, match="static caps"):
        tp.pop()
    tp.close()


def test_planner_pinned_contract():
    """tests/test_pinned.py:36-80 on the port's planner: pinned keys get
    the out-of-bounds slot sentinel, never pull, never flush, and an
    all-pinned stream moves no cache traffic."""
    rng = np.random.default_rng(2)
    NRANK, T, PIN = 4, 8, 32
    n = NRANK * 16 * 10
    ids = (rng.zipf(1.8, (n, T)) - 1) % 500
    pl = CachePlanner(ids, nrank=NRANK, batch_size=16, cache_rows=16 * T,
                      num_shards=NRANK, rows_per_shard=125, epochs=1,
                      n_threads=1, pinned_rows=PIN)
    C = pl.cache_rows
    steps = 0
    while True:
        prog = pl.pop()
        if prog is None:
            break
        steps += 1
        for z in range(NRANK):
            uniq = np.unique(ids[prog.assign[z]])
            pin_pos = np.searchsorted(uniq, uniq[uniq < PIN])
            assert (prog.slots[z][:len(uniq)][pin_pos] == C).all()
            assert not prog.pulls[z][:len(uniq)][pin_pos].any()
            f = prog.flush_ids[z]
            assert not ((f >= 0) & (f < PIN)).any()
    assert steps == pl.batch_num
    pl2 = CachePlanner(rng.integers(0, PIN, (n, T)), nrank=NRANK,
                       batch_size=16, cache_rows=16 * T, num_shards=NRANK,
                       rows_per_shard=125, epochs=1, n_threads=1,
                       pinned_rows=PIN)
    while pl2.pop() is not None:
        pass
    p = pl2.perf()
    assert all(p[k] == 0 for k in ("miss_pull", "miss_push",
                                   "update_pull", "update_push")), p
    pl.close()
    pl2.close()


def test_traffic_profile_matches_jax():
    ids = _ids()
    jp, tp = _pair("hoisting", ids, epochs=1)
    js, jt = jax_sizing.profile_planned_traffic(jp, ids, 4)
    ts, tt = sizing.profile_planned_traffic(tp, ids, 4)
    assert [vars(s) for s in ts] == [vars(s) for s in js]
    assert jt == tt
    jprof = jax_sizing.TrafficProfile.from_steps(js[2:])
    tprof = sizing.TrafficProfile.from_steps(ts[2:])
    assert vars(tprof) == vars(jprof)
    for m in ("pull_capacity", "flush_capacity", "flush_slots",
              "pull_target", "hoisted_pull_capacity", "unique_slots"):
        assert getattr(tprof, m)() == getattr(jprof, m)(), m
    assert sizing.hoist_target_candidates(tprof, 4, 4) == \
        jax_sizing.hoist_target_candidates(jprof, 4, 4)
    jb = jax_sizing.profile_baseline_traffic(ids, MBS * 4, 4)
    tb = sizing.profile_baseline_traffic(ids, MBS * 4, 4)
    assert vars(tb) == vars(jb)
    jp.close()
    tp.close()


def test_sweeps_match_jax():
    """The sweeps build each package's CachedEngine for its caps and
    planner; the port's on the CPU, which allocates nothing."""
    ids = _ids(n=MBS * 40)
    kw = dict(model="wdl_criteo", batch_size=MBS, embedding_dim=8,
              cache_limit=300, sched_hoist_window=4, staleness_bound=1)
    jcfg = JaxConfig(**kw)
    tcfg = HeraldConfig(**kw)
    jeng = JaxCachedEngine(jcfg, table_rows=ROWS)
    jpl = jeng.make_planner(ids, epochs=1, n_threads=1)
    steps, _ = jax_sizing.profile_planned_traffic(jpl, ids, 1)
    jpl.close()
    steady = jax_sizing.TrafficProfile.from_steps(steps[4:])
    targets = jax_sizing.hoist_target_candidates(steady, 1, 1)
    jt, jprof = jax_sizing.sweep_hoist_sizing(jcfg, ROWS, ids, 1, 4,
                                              targets, n_threads=1)
    tt, tprof = sizing.sweep_hoist_sizing(tcfg, ROWS, ids, 1, 4, targets,
                                          n_threads=1)
    assert (tt, vars(tprof)) == (jt, vars(jprof))
    jcfg2 = JaxConfig(**{**kw, "sched_pull_target": jt})
    tcfg2 = HeraldConfig(**{**kw, "sched_pull_target": tt})
    jb, jprof2 = jax_sizing.sweep_flush_budget(jcfg2, ROWS, ids, 1, 4,
                                               jprof, n_threads=1)
    tb, tprof2 = sizing.sweep_flush_budget(tcfg2, ROWS, ids, 1, 4, tprof,
                                           n_threads=1)
    assert (tb, vars(tprof2)) == (jb, vars(jprof2))


def _drain(rp, chunk=6):
    out = []
    while True:
        a = rp.pop_chunk(chunk)
        if a[0] == 0:
            return out
        out.append([np.asarray(x[:a[0]]) for x in a[1:]])


@pytest.mark.parametrize("recorder", ["jax", "port"])
def test_tapes_cross_between_packages(tmp_path, recorder):
    """A tape recorded by either package replays in the other: the same
    key, the same arrays, the same dirty dump and counters."""
    ids = _ids(n=MBS * 30)
    kw = dict(model="wdl_criteo", batch_size=MBS, embedding_dim=8,
              cache_limit=260, pinned_rows=16)
    jeng = JaxCachedEngine(JaxConfig(**kw), table_rows=ROWS)
    teng = CachedEngine(HeraldConfig(**kw), table_rows=ROWS, device="cpu")
    jkey = jax_replay.plan_key(ids, jeng.cfg, 2, ROWS)
    tkey = replay.plan_key(ids, teng.cfg, 2, ROWS)
    assert jkey == tkey
    path = str(tmp_path / "tape")
    if recorder == "jax":
        first = jax_replay.plan_cache(jeng, ids, path, epochs=2,
                                      n_threads=1)
        other = replay.plan_cache(teng, ids, path, epochs=2, n_threads=1)
    else:
        first = replay.plan_cache(teng, ids, path, epochs=2, n_threads=1)
        other = jax_replay.plan_cache(jeng, ids, path, epochs=2,
                                      n_threads=1)
    mtime = os.path.getmtime(os.path.join(path, "meta.json"))
    assert type(other).__module__.startswith(
        "herald_tpu_torch" if recorder == "jax" else "herald_tpu.")
    # the second package replayed the first one's tape: nothing re-recorded
    assert os.path.getmtime(os.path.join(path, "meta.json")) == mtime
    live = teng.make_planner(ids, epochs=2, n_threads=1)
    want = _drain(live)
    for rp in (first, other):
        assert rp.batch_num == live.batch_num
        got = _drain(rp)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                np.testing.assert_array_equal(x, y)
        assert rp.perf() == live.perf()
        for x, y in zip(rp.dirty_rows(0), live.dirty_rows(0)):
            np.testing.assert_array_equal(x, y)
    live.close()
    # fast-forward on a tape: resume from the middle
    rp = replay.ReplayPlanner(path, expect_key=tkey)
    assert rp.fast_forward(7) == 7
    for x, y in zip(rp.pop_chunk(3)[1:], want[1]):
        np.testing.assert_array_equal(np.asarray(x), y[1:4])
    with pytest.raises(ValueError, match="different"):
        replay.ReplayPlanner(path, expect_key="0" * 32)
