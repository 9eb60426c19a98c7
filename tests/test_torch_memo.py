"""The staged-chunk memo and the packed wire's narrowings of the port's
cached engine (`herald_tpu_torch/train/cached.py` `_memo_stage`,
`_chunk_program`) against herald_tpu's (`herald_tpu/train/cached.py`
`_memo_stage`, `_stage_chunk`), on the CPU.

JAX's side runs as `tests/test_packed_wire.py` runs it, on JAX's own CPU
devices: 3 epochs of a fully cacheable stream (`cache_limit_ratio=1.0`,
600 rows, batch 16, chunks of 6), whose epochs 2 and 3 re-plan the same
programs. Both engines start from one JAX state (`bridge.py`).

Tolerances: the port against itself (memo on and off, narrowed wire and
full wire, a staged buffer before and after its steps) is bit-exact; the
port against JAX, as `tests/test_torch_cached.py` holds f32 runs: losses
within 1e-6, table and cache within 1e-5. Memo hits and the memo's state
(on or off) are equal to JAX's.
"""

import jax
import numpy as np
import pytest
import torch

from _ranks import run_ranks
from herald_tpu import HeraldConfig as JaxConfig
from herald_tpu.data import synthetic_ctr_data
from herald_tpu.launch.cli import build_parser as jax_parser
from herald_tpu.launch.cli import run_training as jax_run
from herald_tpu.models import get_model
from herald_tpu.train.cached import CachedEngine as JaxCachedEngine
from herald_tpu_torch import HeraldConfig
from herald_tpu_torch.bridge import state_from_numpy
from herald_tpu_torch.launch import cli
from herald_tpu_torch.train.cached import CachedEngine, StagedChunk

B, STEPS, ROWS = 16, 24, 600


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # the launches are small: one intra-op thread each (as
    # tests/test_torch_launch.py runs them under parallel workers)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_compile_cache():
    # herald_tpu.launch turns on a persistent compile cache under /tmp:
    # off for the whole module, before its module-scoped launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HERALD_COMPILE_CACHE", "")
        yield


def _data(rows=ROWS, n=B * STEPS, seed=9):
    return synthetic_ctr_data(get_model("wdl_criteo").spec, n, seed=seed,
                              num_rows=rows)


def _cfg(**kw):
    return {**dict(model="wdl_criteo", batch_size=B, embedding_dim=8,
                   comm_mode="local", learning_rate=0.5,
                   cache_limit_ratio=1.0), **kw}


def _port_run(jst, epochs=3, feed="index", rows=ROWS, data=None, **kw):
    """The port's `_train_memo`: (table, cache, losses, memo_hits,
    memo on, staged chunks) from the bridged JAX state `jst`."""
    dense, sparse, labels = data or _data(rows)
    eng = CachedEngine(HeraldConfig(**_cfg(**kw)), table_rows=rows,
                       device="cpu")
    st = state_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    planner = eng.make_planner(sparse, epochs=epochs, n_threads=1)
    dd = (eng.stage_dataset(dense, sparse.astype(np.int32), labels)
          if feed == "index" else None)
    losses, staged = [], []
    real = eng._stage_chunk

    def stage(*a, **k):
        staged.append(real(*a, **k))
        return staged[-1]
    eng._stage_chunk = stage
    while True:
        st, stats = eng.train_epoch_cached(st, planner, dense, sparse,
                                           labels, steps=6, device_data=dd)
        if stats is None:
            break
        losses.append(stats["loss"].numpy().copy())
    st = eng.sync_cache(st, planner)
    planner.close()
    return (st.table.numpy().copy(), st.cache.numpy().copy(),
            np.concatenate(losses), eng.memo_hits, eng._memo_on, staged)


def _jax_run(epochs=3, rows=ROWS, **kw):
    """JAX's `_train_memo` (tests/test_packed_wire.py:234-258), with its
    initial state kept for the port."""
    dense, sparse, labels = _data(rows)
    eng = JaxCachedEngine(JaxConfig(**_cfg(**kw)), table_rows=rows)
    planner = eng.make_planner(sparse, epochs=epochs, n_threads=1)
    jst = eng.init_cached_state(0)
    init = jax.tree.map(np.asarray, jst)
    st = jst
    dd = eng.stage_dataset(dense, sparse.astype(np.int32), labels)
    losses = []
    while True:
        st, stats = eng.train_epoch_cached(st, planner, dense, sparse,
                                           labels, steps=6, device_data=dd)
        if stats is None:
            break
        losses.append(np.asarray(stats["loss"]))
    st = eng.sync_cache(st, planner)
    planner.close()
    return (init, np.asarray(st.table), np.asarray(st.cache),
            np.concatenate(losses), eng.memo_hits, eng._memo_on)


@pytest.fixture(scope="module")
def jax_memo():
    return _jax_run()


def _held_to_jax(port, jx):
    table, cache, losses = port[:3]
    np.testing.assert_allclose(losses, jx[3], rtol=0, atol=1e-6)
    np.testing.assert_allclose(table, jx[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(cache, jx[2], rtol=0, atol=1e-5)


def _same(a, b):
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("feed", ["index", "direct"])
def test_memo_hits_like_jax_and_trains_bit_exact(jax_memo, feed):
    on = _port_run(jax_memo[0], feed=feed)
    off = _port_run(jax_memo[0], feed=feed, sched_chunk_memo=False)
    _same(on, off)
    _held_to_jax(on, jax_memo)
    # 3 epochs of 4 chunks: epoch 3 replays epoch 2's programs
    assert on[3] == jax_memo[4] >= 4
    assert on[4] == jax_memo[5] is True
    assert off[3] == 0 and off[4] is False
    # a hit hands back the staged chunk itself: nothing is copied again
    assert len({id(s) for s in on[5]}) == len(on[5]) - on[3]


def test_zero_budget_turns_the_memo_off_like_jax(jax_memo):
    jx = _jax_run(sched_chunk_memo_mb=0)
    on = _port_run(jax_memo[0], sched_chunk_memo_mb=0)
    off = _port_run(jax_memo[0], sched_chunk_memo=False)
    _same(on, off)
    _held_to_jax(on, jx)
    assert on[3] == jx[4] == 0
    assert on[4] is jx[5] is False


def test_packed_wire_off_never_consults_the_memo_like_jax(jax_memo):
    jx = _jax_run(sched_packed_wire=False)
    port = _port_run(jax_memo[0], sched_packed_wire=False)
    _same(port, _port_run(jax_memo[0]))
    assert port[3] == jx[4] == 0
    assert port[4] is jx[5] is True


def test_collided_key_churn_disables_like_jax():
    """tests/test_packed_wire.py::test_chunk_memo_collided_key_churn_disables
    on both engines: equal first and last 64 bytes and layout, other
    bytes, so every insert replaces the last without a reuse."""
    jeng = JaxCachedEngine(JaxConfig(**_cfg(sched_chunk_memo_mb=1)),
                           table_rows=900)
    eng = CachedEngine(HeraldConfig(**_cfg(sched_chunk_memo_mb=1)),
                       table_rows=900, device="cpu")
    layout = eng._host_feed({"x": np.zeros((1, 1 << 20), np.uint8)
                             .view(np.int32)}, 1)[1]
    steps = ((False,) * 5,)
    turned_off = []
    for i in range(1, 8):
        buf = np.zeros(1 << 20, np.uint8)
        buf[1000] = i
        jeng._memo_stage(2, buf, (((1 << 20,), "|u1"),), False,
                         lambda b: jax.device_put(b), mesh=False)
        eng._memo_stage(1, 2, False, steps,
                        torch.from_numpy(buf.reshape(1, -1)), layout)
        turned_off.append((eng._memo_on, jeng._memo_on))
        if not jeng._memo_on:
            break
    assert all(a == b for a, b in turned_off), turned_off
    assert not eng._memo_on and not jeng._memo_on
    assert eng.memo_hits == jeng.memo_hits == 0
    assert not eng._chunk_memo and not jeng._chunk_memo


def _popped(eng, sparse, steps=4):
    planner = eng.make_planner(sparse, epochs=1, n_threads=1)
    out = planner.pop_chunk(steps)
    planner.close()
    return out


def test_same_chunk_hits_and_one_byte_of_this_rank_misses():
    """JAX's `test_mesh_chunk_memo_reuses_identical_buffers` on one
    device: staging the same popped chunk twice returns the same
    StagedChunk, and a one-byte change in this rank's columns (an entry
    of `inv`, which no step flag reads) misses: the full compare decides,
    not the sampled key."""
    dense, sparse, labels = _data(900, B * 8, seed=1)
    eng = CachedEngine(HeraldConfig(**_cfg(cache_limit_ratio=0.6)),
                       table_rows=900, device="cpu")
    out = _popped(eng, sparse)

    def stage():
        return eng._stage_chunk(*out, dense, sparse, labels,
                                index_feed=False)
    s1 = stage()
    s2 = stage()
    assert isinstance(s1, StagedChunk) and s2 is s1 and eng.memo_hits == 1
    out[9][0, 0] ^= 1
    s3 = stage()
    assert s3 is not s1 and eng.memo_hits == 1
    assert s3.layout == s1.layout and s3.steps == s1.steps
    assert not torch.equal(s3.packed, s1.packed)


def _stream_rank(rank, S, init, out):
    """On each of S gloo ranks: (1) the same chunk staged twice, then with
    a flush added in another worker's columns of a step that flushed
    nowhere (this rank's bytes unchanged, the step's flush flag flipped);
    (2) a stream of chunks with flushes, pulls and a pinned tier run
    uncaptured, each chunk's staged bytes compared before and after its
    steps."""
    torch.set_num_threads(1)
    from herald_tpu_torch.parallel import comm
    comm.setup("cpu", init_method=init, rank=rank, world_size=S)
    res = {}
    dense, sparse, labels = _data(1200, B * S * 8, seed=1)
    eng = CachedEngine(HeraldConfig(**{**_cfg(cache_limit_ratio=0.6),
                                       "comm_mode": "hybrid"}),
                       table_rows=1200, device="cpu")
    o = _popped(eng, sparse)
    K, fids, fslots = o[0], o[4], o[5]
    k = int(np.flatnonzero(~(fids[:K] >= 0).any(axis=1))[0])
    other = (rank + 1) % S
    w = fids.shape[1] // S

    def stage():
        return eng._stage_chunk(*o, dense, sparse, labels, index_feed=False)
    s1 = stage()
    res["twice_same"] = stage() is s1
    fids[k, other * w] = 7
    fslots[k, other * w] = 0
    s3 = stage()
    res["other_rank_flush"] = dict(
        missed=s3 is not s1, same_bytes=torch.equal(s3.packed, s1.packed),
        flush_flags=(s1.steps[k][0], s3.steps[k][0]), hits=eng.memo_hits)

    dense, sparse, labels = _data(2000, B * S * 12, seed=3)
    eng = CachedEngine(HeraldConfig(**{**_cfg(cache_limit_ratio=0.3),
                                       "comm_mode": "hybrid",
                                       "pinned_rows": 32}),
                       table_rows=2000, device="cpu")
    st = eng.init_cached_state(0)
    planner = eng.make_planner(sparse, epochs=2, n_threads=1)
    changed, flushed = [], 0
    while True:
        o = planner.pop_chunk(4)
        if o[0] == 0:
            break
        staged = eng._stage_chunk(*o, dense, sparse, labels,
                                  index_feed=False)
        before = staged.packed.clone()
        st, _ = eng.train_epoch_staged(st, staged)
        changed.append(not torch.equal(before, staged.packed))
        flushed += sum(s[0] for s in staged.steps)
    planner.close()
    res["uncaptured"] = dict(changed=changed, flush_steps=flushed)
    torch.save(res, out / f"memo.r{rank}.pt")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("memo2")
    run_ranks(_stream_rank, 2, out, out, timeout=180)
    return [torch.load(out / f"memo.r{r}.pt", weights_only=False)
            for r in range(2)]


@pytest.mark.parametrize("rank", [0, 1])
def test_other_ranks_flush_columns_miss_over_two_ranks(two_ranks, rank):
    res = two_ranks[rank]
    assert res["twice_same"]
    o = res["other_rank_flush"]
    # this rank's packed bytes are equal, but the step now runs the flush
    # exchange: a hit would skip a collective the other rank enters
    assert o["same_bytes"] and o["flush_flags"] == (False, True)
    assert o["missed"] and o["hits"] == 1


@pytest.mark.parametrize("rank", [0, 1])
def test_uncaptured_steps_leave_staged_bytes_over_two_ranks(two_ranks,
                                                            rank):
    res = two_ranks[rank]["uncaptured"]
    assert res["flush_steps"] > 0 and len(res["changed"]) > 2
    assert not any(res["changed"])


@pytest.mark.parametrize("feed", ["index", "direct"])
def test_uncaptured_steps_leave_staged_bytes(feed):
    """Every body of the one-device step (flush to table and cache, pull,
    prefetch insert, pinned tier, update) reads its inputs from views of
    the staged buffer: none writes into them, so a memoized chunk stays
    what it was staged as."""
    dense, sparse, labels = _data(2000, B * 24, seed=11)
    # tests/test_torch_executor.py's stream: a cache of two batches' ids,
    # a pinned tier over concentrated ids, prefetches hoisted early
    sparse = np.where(np.random.default_rng(11).random(sparse.shape) < 0.5,
                      sparse % 48, sparse).astype(np.int32)
    eng = CachedEngine(HeraldConfig(**_cfg(
        cache_limit=2 * B * 26, pinned_rows=32, staleness_bound=2,
        sched_pull_target=8, sched_hoist_window=6,
        sched_prefetch_slots=64)), table_rows=2000, device="cpu")
    assert eng.P_cap > 0
    st = eng.init_cached_state(0)
    planner = eng.make_planner(sparse, epochs=2, n_threads=1)
    dd = (eng.stage_dataset(dense, sparse, labels) if feed == "index"
          else None)
    seen = set()
    while True:
        o = planner.pop_chunk(4)
        if o[0] == 0:
            break
        staged = eng._stage_chunk(*o, dense, sparse, labels,
                                  index_feed=feed == "index")
        before = staged.packed.clone()
        st, _ = eng.train_epoch_staged(st, staged, device_data=dd)
        assert torch.equal(before, staged.packed)
        seen |= {i for s in staged.steps for i, on in enumerate(s) if on}
    planner.close()
    assert seen == {0, 1, 2, 3, 4}      # every write and phase ran


def _narrow_run(jst, packed):
    return _port_run(jst, sched_packed_wire=packed, sched_chunk_memo=False)


def test_narrowed_wire_saves_its_bytes_and_trains_bit_exact(jax_memo):
    """Under the packed wire on one device `inv` ships as int16 and an
    index row in stream order as its base; the steps widen both."""
    narrow = _narrow_run(jax_memo[0], True)
    full = _narrow_run(jax_memo[0], False)
    _same(narrow, full)
    _held_to_jax(narrow, jax_memo)
    fields = {f.name: f for f in narrow[5][0].layout.fields}
    wide = {f.name: f for f in full[5][0].layout.fields}
    assert fields["inv"].dtype == torch.int16 and fields["idx"].shape == (1,)
    assert wide["inv"].dtype == torch.int32 and wide["idx"].shape == (B,)
    eng = CachedEngine(HeraldConfig(**_cfg()), table_rows=ROWS,
                       device="cpu")
    off = CachedEngine(HeraldConfig(**_cfg(sched_packed_wire=False)),
                       table_rows=ROWS, device="cpu")

    def aligned(n):
        return -(-n // 16) * 16
    F = get_model("wdl_criteo").spec.num_sparse
    saved = (aligned(B * F * 4) - aligned(B * F * 2)
             + aligned(B * 4) - aligned(4))
    assert eng.staged_step_bytes(narrow=False) == off.staged_step_bytes()
    assert eng.staged_step_bytes() == off.staged_step_bytes() - saved
    assert narrow[5][0].layout.nbytes == eng.staged_step_bytes()


def test_shuffled_and_multi_worker_rows_stay_full():
    """Only a row in stream order narrows: a shuffled stream ships its
    indices, and `staged_step_bytes` says so."""
    dense, sparse, labels = _data()
    eng = CachedEngine(HeraldConfig(**_cfg(sched_shuffle_seed=3)),
                       table_rows=ROWS, device="cpu")
    s = eng._stage_chunk(*_popped(eng, sparse), index_feed=True)
    fields = {f.name: f for f in s.layout.fields}
    assert fields["idx"].shape == (B,) and fields["inv"].dtype == torch.int16
    assert eng.staged_step_bytes() == s.layout.nbytes


# ----------------------------------------------------------------------
# the launcher (tests/test_cli.py:282-337 on both launchers)
# ----------------------------------------------------------------------

MEMO_CLI = ["--model", "wdl_criteo", "--comm", "local", "--scheduled",
            "--batch-size", "16", "--samples", "1536", "--rows", "900",
            "--cache-limit-ratio", "1.0", "--lr", "0.5",
            "--nepoch", "4", "--scan-steps", "8", "--val-ratio", "0.25",
            "--prestage", "3", "--prestage-threads", "2", "--seed", "11"]
# the report's clocks
CLOCKS = ("examples_per_sec", "examples_per_sec_steady",
          "examples_per_sec_steady_segments", "train_time_s", "step_time",
          "wall_s", "total_time_s", "timing")


def _port_cli(argv):
    return cli.run_training(cli.build_parser().parse_args(
        argv + ["--device", "cpu"]))


def _untimed(rep):
    rep = {k: v for k, v in rep.items() if k not in CLOCKS}
    rep["cache"] = {k: v for k, v in rep["cache"].items()
                    if k != "plan_time_us"}
    rep["epochs"] = [{k: v for k, v in e.items() if "time" not in k
                      and not k.endswith("_s")} for e in rep["epochs"]]
    return rep


@pytest.fixture(scope="module")
def memo_launches():
    memo = _port_cli(MEMO_CLI)
    plain = _port_cli(MEMO_CLI + ["--no-chunk-memo"])
    return memo, plain, jax_run(jax_parser().parse_args(MEMO_CLI))


def test_threaded_prestage_memo_reports_like_jax(memo_launches):
    memo, plain, jx = memo_launches
    assert memo["chunk_memo_active"] is jx["chunk_memo_active"] is True
    assert memo["chunk_memo_hits"] == jx["chunk_memo_hits"] > 0
    assert plain["chunk_memo_hits"] == 0
    assert plain["chunk_memo_active"] is False
    a, b = _untimed(memo), _untimed(plain)
    for k in ("chunk_memo_hits", "chunk_memo_active"):
        a.pop(k), b.pop(k)
    assert a == b
    assert memo["steps"] == jx["steps"] and memo["overflow_rows"] == 0


def test_bounded_stats_depth_reports_the_same(memo_launches, monkeypatch):
    monkeypatch.setenv("HERALD_STATS_DEPTH", "1")
    assert cli._ChunkStats().depth == 1
    bounded = _port_cli(MEMO_CLI)
    assert _untimed(bounded) == _untimed(memo_launches[0])
    monkeypatch.delenv("HERALD_STATS_DEPTH")
    from herald_tpu.launch.cli import _ChunkStats as JaxChunkStats
    assert cli._ChunkStats().depth == JaxChunkStats().depth == 1 << 20


def test_memo_flags_reach_the_config_on_both_paths(tmp_path):
    from herald_tpu.launch.cli import resolve_config as jax_resolve
    base = ["--model", "wdl_criteo", "--comm", "local", "--scheduled",
            "--batch-size", "16", "--rows", "900",
            "--cache-limit-ratio", "0.6"]
    for argv in (base, base + ["--no-chunk-memo", "--chunk-memo-mb", "17"]):
        mine = cli.resolve_config(cli.build_parser().parse_args(argv))
        theirs = jax_resolve(jax_parser().parse_args(argv))
        assert (mine.sched_chunk_memo, mine.sched_chunk_memo_mb) == \
            (theirs.sched_chunk_memo, theirs.sched_chunk_memo_mb)
    assert mine.sched_chunk_memo_mb == 17 and not mine.sched_chunk_memo
    cfgf = str(tmp_path / "memo.json")
    _port_cli(base + ["--samples", "256", "--nepoch", "1", "--scan-steps",
                      "4", "--val-ratio", "0.25", "--save-config", cfgf])
    argv = ["--config", cfgf, "--no-chunk-memo", "--chunk-memo-mb", "33"]
    mine = cli.resolve_config(cli.build_parser().parse_args(argv))
    theirs = jax_resolve(jax_parser().parse_args(argv))
    assert not mine.sched_chunk_memo and mine.sched_chunk_memo_mb == 33
    assert (theirs.sched_chunk_memo, theirs.sched_chunk_memo_mb) == \
        (False, 33)


def test_memo_keeps_its_counts_under_a_pool_of_threads():
    """The prestager's pool stages from several threads: 16 of them stage
    the same chunks at once, with a short switch interval. Each miss
    stages a new chunk and each hit returns one, so the hits are the
    calls less the chunks made, and the memo's byte count is its
    entries' bytes."""
    import sys
    import threading
    dense, sparse, labels = _data(900, B * 8, seed=1)
    eng = CachedEngine(HeraldConfig(**_cfg(cache_limit_ratio=0.6)),
                       table_rows=900, device="cpu")
    planner = eng.make_planner(sparse, epochs=1, n_threads=1)
    chunks = [planner.pop_chunk(2) for _ in range(4)]
    planner.close()
    got, lock = [], threading.Lock()

    def stage():
        mine = [eng._stage_chunk(*c, index_feed=True)
                for _ in range(5) for c in chunks]
        with lock:
            got.extend(mine)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=stage) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 16 * 5 * len(chunks)
    made = len({id(s) for s in got})
    assert eng.memo_hits == len(got) - made > 0
    assert eng._memo_bytes == sum(
        b.nbytes for b, _ in eng._chunk_memo.values())
    assert len(eng._chunk_memo) == len(chunks)
