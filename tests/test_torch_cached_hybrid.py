"""The port's cached engine over S ranks (`CachedEngine(comm_mode=
"hybrid")`: the table row-sharded over a gloo group of S CPU ranks,
`tests/_ranks.py`, rank 0 planning for S workers through
`sched.service.BroadcastPlanner`) against herald_tpu's hybrid
CachedEngine on the first S of the 8 CPU devices, and its launcher branch
under `torch.distributed.run`.

Each S runs its ranks once (`_cached_rank`, torch only; JAX runs in the
test process), over jobs the test process prepares. Every training job
starts both packages from one JAX `CachedTrainState` (split into the
ranks' blocks by `bridge.shard_state`) and plans one stream made once:
JAX's native planner in the test process, the port's on rank 0.
- planner (S = 2, 4): `BroadcastPlanner`'s chunks (a last short one
  included), `fast_forward`, `dirty_rows` and `perf` on every rank equal
  the native `CachePlanner(nrank=S)`'s bit for bit; `iter_time_us` is
  rank 0's on every rank;
- learns (S = 2, 4): `tests/test_cached.py::test_cached_hybrid_learns`'s
  setup (wdl_criteo, batch 16, embedding 16, lr 2.0, cache ratio 0.3),
  one epoch of `train_step_cached`, then `sync_cache` and `evaluate`;
- epoch, epoch_idx (S = 2): the same through `train_epoch_cached` in
  chunks of 5 (the last one short), direct and index feed;
- pinned, pinned_adagrad (S = 2; pinned also S = 4): a 27-row pinned tier
  (28 rows over the ranks) on a stream concentrated on low ids, under SGD
  and under adagrad on the table;
- wire_f32, wire_bf16, wire_int8 (S = 2):
  `test_bf16_flush_wire_close_to_exact`'s setup (batch 8, embedding 8,
  lr 0.5, cache ratio 0.5, 10 steps) on each flush wire; lr0_f32 and
  lr0_int8 the same at lr 0 (`test_int8_flush_conserves_gradient_mass`);
- tight (S = 2, 4): `a2a_flush_capacity` 4, so that the planner defers
  planned flushes;
- uneven (S = 2): `test_tight_budget_rotates_planned_flushes`'s crafted
  stream (round-robin placement), on which worker 0 flushes in steps
  where worker 1 does not;
- init (S = 2, 4): each rank's `init_cached_state(0)` against the
  one-device engine's.

Tolerances, with the largest differences measured here: losses within
rtol 1e-5 (measured 2.0e-7), overflow counts and planner counters equal;
f32 tables (joined, after `sync_cache`), caches, hot blocks and dense
params within 1e-5 (measured 7.5e-9; 2.7e-6 for the adagrad case's hot
block); AUC within 1e-4 (measured 1.9e-6). Under adagrad on the table a
row's step divides by the root of its summed squared deltas, so where
that sum is tiny an f32 ulp of delta becomes a larger step: table and
cache at most 0.1% of elements beyond 1e-5 and all within 1e-2, each
table element beyond it one whose sum is below 1e-5 (measured 2.0e-3 in
7 of 16,000 table elements, with sums of 1e-16 to 8e-6; the cache
2.2e-5), the hot slots within 1e-5 of their largest value (measured
1.8e-6 relative). The bf16 wire within one bf16 ulp of the value plus
2^-13 (measured 2.3e-10); the int8 wire's delta planes, which hold the
quantization residuals, within 1e-5 (measured 3.0e-10). The hot block,
the tower and the losses are bit-identical on every rank. K3 and XLA sum
in other orders, so f32 values drift by ulps.
"""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _ranks import launch_rank, run_ranks
from herald_tpu_torch import HeraldConfig
from herald_tpu_torch.bridge import join_states, shard_state, state_to_numpy
from herald_tpu_torch.data import synthetic_ctr_data
from herald_tpu_torch.models import get_model
from herald_tpu_torch.parallel import comm as C
from herald_tpu_torch.train import engine as E
from herald_tpu_torch.train.cached import CachedEngine, CachedTrainState

REPO = Path(__file__).resolve().parents[1]
ROWS = 2000
SPEC = get_model("wdl_criteo").spec
# name: (HeraldConfig fields, steps, how it runs, data, S values); the
# fields extend wdl_criteo with comm_mode="hybrid"
LEARNS = dict(batch_size=16, embedding_dim=16, learning_rate=2.0,
              cache_limit_ratio=0.3)
WIRE = dict(batch_size=8, embedding_dim=8, learning_rate=0.5,
            cache_limit_ratio=0.5)
CASES = {
    "learns": (LEARNS, 16, "steps", "plain", (2, 4)),
    "epoch": (LEARNS, 16, "chunks", "plain", (2,)),
    "epoch_idx": (LEARNS, 16, "index", "plain", (2,)),
    "pinned": ({**WIRE, "pinned_rows": 27}, 10, "chunks", "hot", (2, 4)),
    "pinned_adagrad": ({**WIRE, "pinned_rows": 27,
                        "embed_optimizer": "adagrad",
                        "embed_learning_rate": 0.5}, 10, "chunks", "hot",
                       (2,)),
    "wire_f32": (WIRE, 10, "chunks", "plain", (2,)),
    "wire_bf16": ({**WIRE, "flush_wire_dtype": "bfloat16"}, 10, "chunks",
                  "plain", (2,)),
    "wire_int8": ({**WIRE, "flush_wire_dtype": "int8"}, 10, "chunks",
                  "plain", (2,)),
    "lr0_f32": ({**WIRE, "learning_rate": 0.0}, 10, "chunks", "plain",
                (2,)),
    "lr0_int8": ({**WIRE, "learning_rate": 0.0, "flush_wire_dtype": "int8"},
                 10, "chunks", "plain", (2,)),
    "tight": ({**WIRE, "a2a_flush_capacity": 4}, 10, "chunks", "plain",
              (2, 4)),
    "uneven": (dict(batch_size=4, embedding_dim=8, learning_rate=0.5,
                    cache_limit=512), 40, "chunks", "uneven", (2,)),
}
# port-only cases: no JAX run of their own
PORT_ONLY = {"epoch_idx", "wire_f32", "lr0_f32", "lr0_int8"}
INIT_ROWS, INIT_CHUNK, INIT_PINNED = 1001, 333, 27
LAUNCH = ["--model", "wdl_criteo", "--batch-size", "8", "--embedding-size",
          "8", "--samples", "800", "--rows", "1500", "--val-ratio", "0.2",
          "--seed", "5", "--lr", "0.5", "--scheduled",
          "--cache-limit-ratio", "0.3", "--scan-steps", "8"]


def _f32(a):
    """A host array of either package as f32 (bf16 as `V2` bits or
    ml_dtypes)."""
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _stream(kind: str, S: int, b: int, steps: int, seed: int):
    """(dense, sparse, labels) of `steps` global batches of S*b samples.
    "hot" sends half the ids to the 64 lowest rows, so a pinned tier
    matters; "uneven" is the crafted stream of
    test_tight_budget_rotates_planned_flushes (26 ids a sample, worker 1
    reads worker 0's block A on odd steps, round-robin placement)."""
    n = S * b * steps
    d, s, y = synthetic_ctr_data(SPEC, n, seed=seed, num_rows=ROWS)
    if kind == "hot":
        s = np.where(np.random.default_rng(seed).random(s.shape) < 0.5,
                     s % 64, s)
    elif kind == "uneven":
        T = SPEC.num_sparse
        blocks = [np.arange(o, o + T) for o in (10, 50, 90)]   # A, B, C
        for t in range(steps):
            for j in range(S * b):
                z = j % S
                row = (blocks[0] if t % 2 == 0 else blocks[2]) if z == 0 \
                    else (blocks[1] if t % 2 == 0 else blocks[0])
                s[t * S * b + j] = row
    return d, s.astype(np.int32), y


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
def _broadcast_planner(eng, sparse, assign_mode):
    from herald_tpu_torch.sched.service import BroadcastPlanner
    return BroadcastPlanner(
        lambda: eng.make_planner(sparse, epochs=1, n_threads=2,
                                 assign_mode=assign_mode),
        eng.comm, num_samples=len(sparse), nrank=eng.num_shards,
        batch_size=eng.cfg.batch_size, unique_cap=eng.U_cap,
        flush_cap=eng.F_cap, cache_rows=eng.cache_rows, epochs=1,
        prefetch_cap=eng.P_cap, num_tables=eng.model.spec.num_sparse)


def _train_job(job):
    eng = CachedEngine(HeraldConfig.from_json(job["cfg"]), table_rows=ROWS,
                       device="cpu")
    st = CachedTrainState(**torch.load(job["state"][eng.rank],
                                       weights_only=False))
    d, s, y = job["data"]
    pl = _broadcast_planner(eng, s, job["assign_mode"])
    losses, overflow = [], []
    dev = eng.stage_dataset(d, s, y) if job["how"] == "index" else None
    while True:
        if job["how"] == "steps":
            st, stats = eng.train_step_cached(st, pl, d, s, y)
        else:
            st, stats = eng.train_epoch_cached(st, pl, d, s, y, steps=5,
                                               device_data=dev)
        if stats is None:
            break
        losses.extend(np.atleast_1d(stats["loss"].numpy()).tolist())
        overflow.extend(np.atleast_1d(stats["overflow"].numpy()).tolist())
    perf = pl.perf()
    # copies: on the CPU the arrays are views of the state's tensors,
    # which sync_cache changes in place
    before = copy.deepcopy(state_to_numpy(st)._asdict())
    st = eng.sync_cache(st, pl)
    pl.close()
    return {"losses": losses, "overflow": overflow, "perf": perf,
            "pinned_rows": eng.pinned_rows, "before_sync": before,
            "state": state_to_numpy(st)._asdict(),
            "eval": eng.evaluate(st, d, s, y)}


def _planner_job(job):
    from herald_tpu_torch.sched.planner import CachePlanner
    from herald_tpu_torch.sched.service import BroadcastPlanner
    comm = C.setup("cpu")
    ids, kw, shape = job["ids"], job["kw"], job["shape"]
    res = {}
    try:        # rank 0 reads the table count off its planner
        BroadcastPlanner(lambda: CachePlanner(ids, **kw), comm,
                         num_tables=0, **shape).close()
        res["no_num_tables"] = "ok"
    except ValueError as e:
        res["no_num_tables"] = str(e)
    bp = BroadcastPlanner(lambda: CachePlanner(ids, **kw), comm,
                          num_tables=ids.shape[1], **shape)
    res["batch_num"] = bp.batch_num
    res["skipped"] = bp.fast_forward(2)
    res["chunks"] = []
    while True:
        out = bp.pop_chunk(job["steps"])
        res["chunks"].append(out)
        if out[0] == 0:
            break
    res["dumps"] = [bp.dirty_rows(z) for z in range(comm.size)]
    res["perf"] = bp.perf()
    res["iter_time_us"] = bp.iter_time_us()
    try:
        res["queue_length"] = bp.queue_length()
    except RuntimeError as e:
        res["queue_length"] = str(e)
    bp.close()
    return res


def _init_job(job):
    E.INIT_CHUNK_ROWS = INIT_CHUNK
    eng = CachedEngine(HeraldConfig.from_json(job["cfg"]),
                       table_rows=INIT_ROWS, device="cpu")
    return {"state": state_to_numpy(eng.init_cached_state(0))._asdict(),
            "pinned_rows": eng.pinned_rows}


def _cached_rank(rank, S, init, out):
    torch.set_num_threads(1)
    C.setup("cpu", init_method=init, rank=rank, world_size=S)
    jobs = torch.load(out / "jobs.pt", weights_only=False)
    run = {"train": _train_job, "planner": _planner_job, "init": _init_job}
    res = {name: run[job["kind"]](job) for name, job in jobs.items()}
    torch.save(res, out / f"r{rank}.pt")


# ---------------------------------------------------------------------------
# the jobs and the references, in the test process
# ---------------------------------------------------------------------------
def _configs(fields):
    """(JAX config, the port's config JSON) of a case's fields."""
    import jax.numpy as jnp
    from herald_tpu import HeraldConfig as JaxConfig
    fields = dict(fields)
    wire = fields.pop("flush_wire_dtype", None)
    jcfg = JaxConfig(model="wdl_criteo", comm_mode="hybrid",
                     flush_wire_dtype=None if wire is None
                     else jnp.dtype(wire).type, **fields)
    return jcfg, HeraldConfig.from_json(jcfg.to_json()).to_json()


def _jax_engine(jcfg, S, rows=ROWS):
    import jax
    from jax.sharding import Mesh
    from herald_tpu.train.cached import CachedEngine as JaxCachedEngine
    mesh = Mesh(np.array(jax.devices()[:S]), ("dp",))
    return JaxCachedEngine(jcfg, mesh=mesh, table_rows=rows)


def _numpy_state(jst):
    """Host copies of a JAX state (a view of a CPU buffer would change
    when a later call takes the buffer over)."""
    import jax
    return jax.tree.map(np.array, jst)


def _jax_run(jeng, jst, data, how, assign_mode):
    """JAX's run of a case: losses, overflow, counters, the state before
    and after sync_cache, and the evaluation."""
    d, s, y = data
    pl = jeng.make_planner(s, epochs=1, n_threads=2,
                           assign_mode=assign_mode)
    losses, overflow = [], []
    while True:
        if how == "steps":
            jst, st = jeng.train_step_cached(jst, pl, d, s, y)
        else:
            jst, st = jeng.train_epoch_cached(jst, pl, d, s, y, steps=5)
        if st is None:
            break
        losses.extend(np.atleast_1d(np.asarray(st["loss"])).tolist())
        overflow.extend(np.atleast_1d(np.asarray(st["overflow"])).tolist())
    perf = pl.perf()
    before = _numpy_state(jst)
    jst = jeng.sync_cache(jst, pl)
    pl.close()
    return {"losses": losses, "overflow": overflow, "perf": perf,
            "before_sync": before, "state": _numpy_state(jst),
            "eval": jeng.evaluate(jst, d, s, y), "engine": jeng}


def _planner_case(S):
    """A native-planner stream with a pinned tier, prefetch hoisting and
    a tight owner budget, for S workers."""
    _, s, _ = _stream("hot", S, 8, 23, seed=3)
    kw = dict(nrank=S, batch_size=8, cache_rows=300, num_shards=S,
              rows_per_shard=-(-ROWS // S), epochs=1, flush_cap=208,
              owner_cap=6, n_threads=2, pinned_rows=16, pull_target=20,
              hoist_window=2, prefetch_cap=16)
    shape = dict(num_samples=len(s), nrank=S, batch_size=8, unique_cap=208,
                 flush_cap=208, cache_rows=300, epochs=1, prefetch_cap=16)
    return {"kind": "planner", "ids": s, "kw": kw, "shape": shape,
            "steps": 6}


def _jax_planner(job):
    from herald_tpu.sched.planner import CachePlanner as JaxCachePlanner
    pl = JaxCachePlanner(job["ids"], **job["kw"])
    res = {"batch_num": pl.batch_num, "skipped": pl.fast_forward(2),
           "chunks": []}
    while True:
        out = pl.pop_chunk(job["steps"])
        res["chunks"].append(out)
        if out[0] == 0:
            break
    res["dumps"] = [pl.dirty_rows(z) for z in range(job["kw"]["nrank"])]
    res["perf"] = pl.perf()
    pl.close()
    return res


def _train_case(S, name, out):
    fields, steps, how, kind, _ = CASES[name]
    jcfg, cfg = _configs(fields)
    jeng = _jax_engine(jcfg, S)
    jst = jeng.init_cached_state(0)
    leaves = _numpy_state(jst)
    data = _stream(kind, S, fields["batch_size"], steps, seed=8)
    assign_mode = "roundrobin" if kind == "uneven" else "affinity"
    paths = []
    for r in range(S):
        paths.append(out / f"{name}.r{r}.pt")
        torch.save(shard_state(leaves, jeng.exchange, r, "cpu")._asdict(),
                   paths[-1])
    job = {"kind": "train", "cfg": cfg, "state": paths, "how": how,
           "data": data, "assign_mode": assign_mode}
    ref = None if name in PORT_ONLY else _jax_run(jeng, jst, data, how,
                                                  assign_mode)
    return job, ref


def _jobs(S, out):
    jobs, refs = {}, {}
    for name, case in CASES.items():
        if S in case[-1]:
            jobs[name], refs[name] = _train_case(S, name, out)
    jobs["planner"] = _planner_case(S)
    refs["planner"] = _jax_planner(jobs["planner"])
    icfg = dict(model="wdl_criteo", batch_size=8, embedding_dim=8,
                embed_optimizer="adagrad", pinned_rows=INIT_PINNED)
    jobs["init"] = {"kind": "init", "cfg": HeraldConfig(
        **icfg, comm_mode="hybrid").to_json()}
    chunk = E.INIT_CHUNK_ROWS
    E.INIT_CHUNK_ROWS = INIT_CHUNK
    try:
        one = CachedEngine(HeraldConfig(**icfg), table_rows=INIT_ROWS,
                           device="cpu")
        refs["init"] = state_to_numpy(one.init_state(0))
    finally:
        E.INIT_CHUNK_ROWS = chunk
    torch.save(jobs, out / "jobs.pt")
    return refs


def _run(S, tmp_path_factory):
    """(S, the references, [each rank's results])."""
    out = tmp_path_factory.mktemp(f"cached{S}")
    refs = _jobs(S, out)
    run_ranks(_cached_rank, S, out, out, timeout=240)
    return S, refs, [torch.load(out / f"r{r}.pt", weights_only=False)
                     for r in range(S)]


@pytest.fixture(scope="module")
def cached2(tmp_path_factory):
    return _run(2, tmp_path_factory)


@pytest.fixture(scope="module")
def cached4(tmp_path_factory):
    return _run(4, tmp_path_factory)


@pytest.fixture(params=[2, 4], ids=lambda s: f"S{s}")
def cached(request):
    return request.getfixturevalue(f"cached{request.param}")


def _joined(res, name, key="state"):
    return join_states([CachedTrainState(**r[name][key]) for r in res])


def _check(run, name):
    """The case's run on every rank against JAX's: losses, overflow,
    counters, the joined state after sync_cache, the evaluation."""
    S, refs, res = run
    ref = refs[name]
    for r in range(S):
        got = res[r][name]
        assert got["overflow"] == ref["overflow"]
        assert got["perf"] == ref["perf"]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
        assert got["losses"] == res[0][name]["losses"]
        assert abs(got["eval"]["auc"] - ref["eval"]["auc"]) <= 1e-4
    st, want = _joined(res, name), ref["state"]
    ex = ref["engine"].exchange
    assert int(st.step) == int(want.step)
    table, want_table = (ex.to_logical(t.table) for t in (st, want))
    pairs = [(st.hot_table, want.hot_table)]
    pairs += [(ex.to_logical(st.table_slots[k]),
               ex.to_logical(want.table_slots[k]))
              for k in want.table_slots]
    for k in want.dense:
        pairs.append((st.dense[k], want.dense[k]))
    if "accum" in want.table_slots:
        # adagrad divides by the root of a row's summed squared deltas:
        # where that sum is tiny, an f32 ulp of delta is a larger step
        accum = ex.to_logical(want.table_slots["accum"])
        for got, exp, ill in ((table, want_table, accum < 1e-5),
                              (st.cache, want.cache, None)):
            d = np.abs(got - exp)
            assert (d > 1e-5).mean() <= 1e-3 and d.max() <= 1e-2, d.max()
            if ill is not None:
                assert ill[d > 1e-5].all()
    else:
        pairs += [(table, want_table), (st.cache, want.cache)]
    for got, exp in pairs:
        np.testing.assert_allclose(_f32(got), _f32(exp), rtol=0, atol=1e-5)
    for k in want.hot_slots:
        exp = np.asarray(want.hot_slots[k])
        scale = max(float(np.abs(exp).max()), 1e-30)
        np.testing.assert_allclose(st.hot_slots[k], exp, rtol=0,
                                   atol=1e-5 * scale)
    return S, ref, res


# ---------------------------------------------------------------------------
def test_broadcast_planner_equals_the_native_planner(cached):
    S, refs, res = cached
    want = refs["planner"]
    assert want["skipped"] == 2 and len(want["chunks"]) >= 3
    # a last, short chunk before the end of the stream
    assert 0 < want["chunks"][-2][0] < 6
    for r in range(S):
        got = res[r]["planner"]
        assert got["batch_num"] == want["batch_num"]
        assert got["skipped"] == 2
        assert len(got["chunks"]) == len(want["chunks"])
        for g, w in zip(got["chunks"], want["chunks"]):
            K = w[0]
            assert g[0] == K
            for a, b in zip(g[1:], w[1:]):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a[:K], b[:K])
                assert not a[K:].any()
        for (gi, gs), (wi, ws) in zip(got["dumps"], want["dumps"]):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gs, ws)
            assert gs.dtype == ws.dtype == np.int32
        assert got["perf"] == want["perf"]
        assert want["perf"]["deferred_flush"] > 0
        assert want["perf"]["hoisted_pull"] > 0
        assert got["iter_time_us"] == res[0]["planner"]["iter_time_us"] > 0
        if r == 0:
            assert got["no_num_tables"] == "ok"
            assert isinstance(got["queue_length"], int)
        else:
            assert "num_tables" in got["no_num_tables"]
            assert "rank 0" in got["queue_length"]


def test_cached_hybrid_learns_matches_jax(cached):
    """`tests/test_cached.py::test_cached_hybrid_learns` over S ranks, one
    epoch of train_step_cached held step by step to JAX's, then
    sync_cache and evaluate."""
    S, ref, res = _check(cached, "learns")
    assert sum(ref["overflow"]) == 0 and ref["perf"]["deferred_flush"] == 0
    assert ref["perf"]["update_push"] > 0 and ref["perf"]["update_pull"] > 0
    assert res[0]["learns"]["eval"] == res[S - 1]["learns"]["eval"]


def test_cached_epoch_and_index_feed(cached2):
    """train_epoch_cached in chunks (the last one short) against JAX's, and
    the index feed (stage_dataset) bit for bit against the direct feed."""
    S, _, res = _check(cached2, "epoch")
    for r in range(S):
        a, b = res[r]["epoch"], res[r]["epoch_idx"]
        assert a["losses"] == b["losses"]
        for key in ("before_sync", "state"):
            for f in ("table", "cache", "hot_table"):
                np.testing.assert_array_equal(a[key][f], b[key][f])


@pytest.mark.parametrize("name", ["pinned", "pinned_adagrad"])
def test_pinned_tier_over_ranks_matches_jax(cached2, name):
    S, ref, res = _check(cached2, name)
    _pinned_checks(S, ref, res, name)


def test_pinned_tier_over_four_ranks_matches_jax(cached4):
    S, ref, res = _check(cached4, "pinned")
    _pinned_checks(S, ref, res, "pinned")


def _pinned_checks(S, ref, res, name):
    """27 rows round up to a multiple of S; the hot block and the tower are
    bit-identical on every rank; the synced table holds the hot block."""
    P = -(-27 // S) * S
    assert ref["engine"].pinned_rows == P
    for r in range(S):
        got = res[r][name]
        assert got["pinned_rows"] == P
        for key in ("before_sync", "state"):
            np.testing.assert_array_equal(got[key]["hot_table"],
                                          res[0][name][key]["hot_table"])
            for k in got[key]["dense"]:
                np.testing.assert_array_equal(got[key]["dense"][k],
                                              res[0][name][key]["dense"][k])
        for k, v in got["state"]["hot_slots"].items():
            assert v.shape == (P // S, got["state"]["hot_table"].shape[1])
            assert np.abs(v).max() > 0
    st = _joined(res, name)
    ex = ref["engine"].exchange
    np.testing.assert_array_equal(ex.to_logical(st.table)[:P], st.hot_table)


def test_flush_wires_match_jax(cached2):
    """The bf16 wire within one bf16 ulp plus 2^-13 of JAX's bf16-wire run,
    and not the f32 wire's result; the int8 wire's delta planes (the
    quantization residuals) within 1e-5 of JAX's; at lr 0 the int8 wire's
    synced table is the f32 wire's, bit for bit."""
    S, refs, res = cached2
    ex = refs["wire_bf16"]["engine"].exchange
    for name in ("wire_bf16", "wire_int8"):
        ref = refs[name]
        for r in range(S):
            assert res[r][name]["overflow"] == ref["overflow"]
            np.testing.assert_allclose(res[r][name]["losses"],
                                       ref["losses"], rtol=1e-5)
    bf16 = ex.to_logical(_joined(res, "wire_bf16").table)
    np.testing.assert_allclose(
        bf16, ex.to_logical(refs["wire_bf16"]["state"].table),
        rtol=2.0 ** -7, atol=2.0 ** -13)
    f32 = ex.to_logical(_joined(res, "wire_f32").table)
    assert 0 < np.abs(bf16 - f32).max() < 5e-3
    W = WIRE["embedding_dim"]
    got = _joined(res, "wire_int8", "before_sync").cache[:, W:]
    want = np.asarray(refs["wire_int8"]["before_sync"].cache)[:, W:]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(
        ex.to_logical(_joined(res, "wire_int8").table),
        ex.to_logical(refs["wire_int8"]["state"].table), rtol=0, atol=1e-5)
    a, b = (_joined(res, n).table for n in ("lr0_int8", "lr0_f32"))
    np.testing.assert_array_equal(a, b)


def test_tight_flush_capacity_defers_and_overflows_as_jax(cached):
    S, ref, res = _check(cached, "tight")
    assert ref["perf"]["deferred_flush"] > 0, ref["perf"]


def test_uneven_flushes_do_not_hang(cached2):
    """Worker 0 flushes in steps where worker 1 does not: both ranks run
    every flush exchange, and the results are JAX's."""
    S, ref, res = _check(cached2, "uneven")
    jeng = ref["engine"]
    pl = jeng.make_planner(_stream("uneven", 2, 4, 40, seed=8)[1],
                           epochs=1, n_threads=2, assign_mode="roundrobin")
    K, *arrays = pl.pop_chunk(40)
    pl.close()
    fids = arrays[3][:K].reshape(K, 2, -1)
    per_worker = (fids >= 0).sum(axis=2)
    assert ((per_worker[:, 0] > 0) & (per_worker[:, 1] == 0)).any()


def test_init_cached_state_is_the_one_device_engines(cached):
    S, refs, res = cached
    want = refs["init"]
    P = -(-INIT_PINNED // S) * S
    table = np.asarray(want.table)
    for r in range(S):
        got = res[r]["init"]
        assert got["pinned_rows"] == P
        st = got["state"]
        rows = table[r::S]
        np.testing.assert_array_equal(st["table"][:len(rows)], rows)
        assert not st["table"][len(rows):].any()
        np.testing.assert_array_equal(st["hot_table"], table[:P])
        C_rows = HeraldConfig().cache_rows(INIT_ROWS)
        assert st["cache"].shape == (C_rows, 16) and not st["cache"].any()
        assert set(st["hot_slots"]) == {"accum"}
        assert st["hot_slots"]["accum"].shape == (P // S, 8)
        assert not st["hot_slots"]["accum"].any()
        for k, v in want.dense.items():
            np.testing.assert_array_equal(st["dense"][k], v)


@pytest.mark.parametrize("S", [2, 4])
def test_bridge_round_trips_a_jax_cached_state(S):
    """shard_state -> join_states of a JAX hybrid CachedTrainState (a
    pinned tier, adagrad slots on the table and the hot block) is the
    state, bit for bit."""
    jcfg, _ = _configs({**WIRE, "pinned_rows": 27,
                        "embed_optimizer": "adagrad"})
    jeng = _jax_engine(jcfg, S)
    leaves = _numpy_state(jeng.init_cached_state(0))
    rng = np.random.default_rng(S)
    leaves = leaves._replace(
        cache=rng.standard_normal(leaves.cache.shape).astype(np.float32),
        hot_slots={k: rng.standard_normal(v.shape).astype(np.float32)
                   for k, v in leaves.hot_slots.items()})
    ranks = [shard_state(leaves, jeng.exchange, r, "cpu") for r in range(S)]
    for st in ranks:
        assert st.cache.shape[0] == leaves.cache.shape[0] // S
        assert st.hot_slots["accum"].shape[0] == jeng.pinned_rows // S
    back = join_states([state_to_numpy(st) for st in ranks])

    def flat(tree, prefix=""):
        if hasattr(tree, "_asdict"):
            tree = tree._asdict()
        if isinstance(tree, dict):
            return {p: v for k, t in tree.items()
                    for p, v in flat(t, f"{prefix}/{k}").items()}
        return {prefix: np.asarray(tree)}
    got, want = flat(back), flat(leaves)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _reduce_scatter_rank(rank, S, init, out):
    comm = C.setup("cpu", init_method=init, rank=rank, world_size=S)
    x = torch.as_tensor(np.random.default_rng(rank).standard_normal(
        (S * 3, 5)).astype(np.float32))
    got = comm.reduce_scatter(x)
    torch.save({"got": got.numpy(), "x": x.numpy(),
                "seconds": comm.seconds}, out / f"rs{rank}.pt")


@pytest.mark.parametrize("S", [2, 4])
def test_comm_reduce_scatter_is_a_numpy_sum(S, tmp_path):
    run_ranks(_reduce_scatter_rank, S, tmp_path, tmp_path, timeout=120)
    res = [torch.load(tmp_path / f"rs{r}.pt", weights_only=False)
           for r in range(S)]
    total = sum(r["x"].astype(np.float64) for r in res)
    for r, got in enumerate(res):
        assert got["got"].shape == (3, 5)
        np.testing.assert_allclose(got["got"], total[r * 3:(r + 1) * 3],
                                   rtol=1e-6, atol=1e-6)
        assert got["seconds"]["reduce_scatter"] > 0


def test_scheduled_launcher_matches_jax(tmp_path, monkeypatch):
    """`--scheduled` over 2 gloo ranks of the port (`_ranks.launch_rank`)
    against herald_tpu.launch on a 2-device mesh, from JAX's initial
    state: the same global batches and the same planner stream."""
    from herald_tpu import HeraldConfig as JaxConfig
    from herald_tpu.launch.cli import build_parser as jax_parser
    from herald_tpu.launch.cli import run_training as jax_run
    from herald_tpu.train.cached import CachedEngine as JaxCachedEngine
    import jax
    monkeypatch.setenv("HERALD_COMPILE_CACHE", "")
    jcfg = JaxConfig(model="wdl_criteo", batch_size=8, embedding_dim=8,
                     comm_mode="hybrid", mesh_shape=(2,), seed=5,
                     learning_rate=0.5, use_cache=True, use_scheduler=True,
                     cache_limit_ratio=0.3)
    (tmp_path / "cfg.json").write_text(jcfg.to_json())
    orig, captured = JaxCachedEngine.init_cached_state, {}

    def init(self, seed=None):
        st = orig(self, seed)
        captured["spec"] = self.exchange
        captured["state"] = jax.tree.map(np.asarray, st)
        return st
    monkeypatch.setattr(JaxCachedEngine, "init_cached_state", init)
    argv = LAUNCH + ["--comm", "hybrid", "--config",
                     str(tmp_path / "cfg.json")]
    jx = jax_run(jax_parser().parse_args(argv + ["--no-prefetch",
                                                 "--prestage", "0"]))
    for r in range(2):
        torch.save(shard_state(captured["state"], captured["spec"], r,
                               "cpu")._asdict(), tmp_path / f"init.r{r}.pt")
    run_ranks(launch_rank, 2, tmp_path, tmp_path, LAUNCH)
    reports = [torch.load(tmp_path / f"report.r{r}.pt", weights_only=False)
               for r in range(2)]
    for port in reports:
        assert (port["devices"], port["backend"]) == (2, "gloo")
        assert port["mode"] == jx["mode"] == "scheduled"
        assert port["steps"] == jx["steps"] == 640 // 16
        assert port["overflow_rows"] == jx["overflow_rows"] == 0
        assert abs(port["train_loss_last"] - jx["train_loss_last"]) <= 1e-5
        assert abs(port["val_auc"] - jx["val_auc"]) <= 1e-4
        pc, jc = dict(port["cache"]), dict(jx["cache"])
        pc.pop("plan_time_us"), jc.pop("plan_time_us")
        assert pc == jc and pc["update_push"] > 0
    assert reports[0]["val_auc"] == reports[1]["val_auc"]
    assert reports[0]["cache"] == reports[1]["cache"]


@pytest.mark.parametrize("wire", [[], ["--int8-flush"],
                                  ["--autosize", "--pinned-rows", "16"]],
                         ids=["f32", "int8", "autosize"])
def test_scheduled_launcher_under_torch_distributed_run(tmp_path, wire):
    """`python -m torch.distributed.run --nproc-per-node 2 -m
    herald_tpu_torch.launch --comm hybrid --scheduled --device cpu`, with
    and without the int8 flush wire, and autosized (rank 0 probes, every
    rank takes its sizes) with a pinned tier: rank 0 alone prints the
    report."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "herald_tpu_torch.launch",
           *LAUNCH, *wire, "--comm", "hybrid", "--device", "cpu",
           "--log-dir", str(tmp_path / "logs")]
    p = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=180)
    assert p.returncode == 0, p.stderr[-3000:]
    report = json.loads(p.stdout[p.stdout.index("{\n"):])
    assert p.stdout.count('"mode": "scheduled"') == 1
    assert (report["devices"], report["backend"], report["mode"]) == \
        (2, "gloo", "scheduled")
    assert report["steps"] == 640 // 16 and report["overflow_rows"] == 0
    assert np.isfinite(report["train_loss_last"])
    assert report["cache"]["update_push"] > 0
    assert np.load(tmp_path / "logs" / "losses.npy").shape == (40,)
