"""Assign-only mode over S ranks: `BroadcastScheduler`
(`herald_tpu_torch/sched/service.py`; rank 0 alone runs the lookahead
scheduler for S workers and broadcasts each assignment) and
`Engine.train_epoch_assigned` on the hybrid engine, over a gloo group of
S CPU ranks (`tests/_ranks.py`), against herald_tpu's scheduler and
hybrid engine on the first S of the 8 CPU devices; and the launcher's
`--assign-only` under `torch.distributed.run`.

Each S runs its ranks once (`_assigned_rank`), over jobs the test process
prepares, `tests/test_assigned.py`'s three tests on the port:
- sched: the broadcast assignments of a whole stream equal JAX's
  `NativeScheduler(nrank=S, n_threads=1)` pops bit for bit on every rank,
  `perf()` is rank 0's on every rank, and the other ranks'
  `iter_time_us()` is 0, as in JAX;
- engine: from one JAX hybrid state, 6 plain `train_epoch` steps and 6
  `train_epoch_assigned` steps through a `BroadcastScheduler`. Scheduling
  moves samples between ranks and never changes a step's global batch
  set, so the assigned losses equal the plain ones within rtol 1e-5 and
  the final states within JAX's tolerances (dense rtol 1e-4, atol 1e-6;
  table rtol 1e-3, atol 1e-5); rank r trains the samples of assignment
  row r, in its order. Against JAX's assigned run from the same state:
  losses within 1e-6, states within 1e-5 (`tests/test_torch_hybrid.py`'s
  f32 tolerances);
- affinity: on a shuffled sessionized stream, the broadcast assignments
  give fewer unique ids per rank's batch than contiguous batching.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _ranks import run_ranks
from herald_tpu_torch import HeraldConfig
from herald_tpu_torch.bridge import join_states, shard_state, state_to_numpy
from herald_tpu_torch.data import synthetic_ctr_data
from herald_tpu_torch.models import get_model
from herald_tpu_torch.parallel import comm as C
from herald_tpu_torch.sched.scheduler import NativeScheduler
from herald_tpu_torch.sched.service import BroadcastScheduler
from herald_tpu_torch.train.engine import Engine, TrainState

REPO = Path(__file__).resolve().parents[1]
B, ROWS, STEPS = 16, 4096, 6
AFF_B, AFF_STEPS, AFF_ROWS = 64, 24, 262144
LAUNCH = ["--model", "wdl_criteo", "--batch-size", "16",
          "--embedding-size", "8", "--samples", "1024", "--rows", "800",
          "--lr", "0.5", "--nepoch", "1", "--scan-steps", "4",
          "--val-ratio", "0.25", "--cache-limit-ratio", "0.6"]


def _native(sparse, S, b, steps, cache):
    def make():
        s = NativeScheduler(sparse, nrank=S, batch_size=b, batch_num=steps,
                            epochs=1, cache_size=cache, n_threads=1)
        s.start()
        return s
    return make


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
def _sched_job(job, comm):
    sched = BroadcastScheduler(_native(job["sparse"], comm.size, B, STEPS,
                                       ROWS), comm, B)
    pops = []
    while (r := sched.pop()) is not None:
        assert r[1] == []
        pops.append(r[0])
    res = {"pops": pops, "perf": sched.perf(),
           "iter_time_us": sched.iter_time_us()}
    sched.close()
    return res


def _engine_job(job, comm):
    d, s, y = job["data"]
    cfg = HeraldConfig.from_json(job["cfg"])

    def start():
        return TrainState(**torch.load(job["state"][comm.rank],
                                       weights_only=False))
    eng = Engine(cfg, table_rows=ROWS, device="cpu")
    st, stats = eng.train_epoch(start(), d, s, y, steps=STEPS)
    res = {"plain": {"losses": stats["loss"].tolist(),
                     "overflow": stats["overflow"].tolist(),
                     "state": state_to_numpy(st)._asdict()}}
    # the blocks of the ids this rank trains ([steps, B, F])
    blocks = []
    rank_block = eng._rank_block

    def recorded(x, dt, axis=0):
        out = rank_block(x, dt, axis)
        if dt == np.int32:
            blocks.append(out)
        return out
    eng._rank_block = recorded
    sched = BroadcastScheduler(_native(s, comm.size, B, STEPS, ROWS), comm,
                               B)
    pops = []

    class Recorded:
        def pop(self):
            r = sched.pop()
            if r is not None:
                pops.append(r[0])
            return r
    st, stats = eng.train_epoch_assigned(start(), Recorded(), d, s, y,
                                         steps=STEPS)
    sched.close()
    res["assigned"] = {"losses": stats["loss"].tolist(),
                       "overflow": stats["overflow"].tolist(),
                       "state": state_to_numpy(st)._asdict(),
                       "ids": blocks[0], "pops": pops}
    return res


def _affinity_job(job, comm):
    sched = BroadcastScheduler(_native(job["sparse"], comm.size, AFF_B,
                                       AFF_STEPS, AFF_ROWS // 10), comm,
                               AFF_B)
    mine = []
    while (r := sched.pop()) is not None:
        mine.append(len(np.unique(job["sparse"][r[0][comm.rank]])))
    sched.close()
    return {"uniques": mine}


def _assigned_rank(rank, S, init, out):
    torch.set_num_threads(1)
    comm = C.setup("cpu", init_method=init, rank=rank, world_size=S)
    jobs = torch.load(out / "jobs.pt", weights_only=False)
    run = {"sched": _sched_job, "engine": _engine_job,
           "affinity": _affinity_job}
    res = {name: run[name](job, comm) for name, job in jobs.items()}
    torch.save(res, out / f"r{rank}.pt")


# ---------------------------------------------------------------------------
# the jobs and the references, in the test process
# ---------------------------------------------------------------------------
def _jax_pops(sparse, S, b, steps, cache):
    from herald_tpu.sched.scheduler import NativeScheduler as JaxNative
    sched = JaxNative(sparse, nrank=S, batch_size=b, batch_num=steps,
                      epochs=1, cache_size=cache, n_threads=1)
    sched.start()
    pops = []
    while (r := sched.pop()) is not None:
        pops.append(r[0])
    sched.close()
    return pops


def _jobs(S, out):
    import jax
    from jax.sharding import Mesh
    from herald_tpu import HeraldConfig as JaxConfig
    from herald_tpu.sched.scheduler import NativeScheduler as JaxNative
    from herald_tpu.train.engine import Engine as JaxEngine
    jobs, refs = {}, {}
    spec = get_model("wdl_criteo").spec
    d, s, y = synthetic_ctr_data(spec, S * B * STEPS, seed=9, num_rows=ROWS)
    jobs["sched"] = {"sparse": s}
    refs["sched"] = _jax_pops(s, S, B, STEPS, ROWS)

    jcfg = JaxConfig(model="wdl_criteo", batch_size=B, embedding_dim=8,
                     comm_mode="hybrid", learning_rate=0.5,
                     a2a_capacity_factor=8.0)
    mesh = Mesh(np.array(jax.devices()[:S]), ("dp",))
    jeng = JaxEngine(jcfg, mesh=mesh, table_rows=ROWS)
    leaves = jax.tree.map(np.asarray, jeng.init_state(0))
    paths = []
    for r in range(S):
        paths.append(out / f"state.r{r}.pt")
        torch.save(shard_state(leaves, jeng.exchange, r, "cpu")._asdict(),
                   paths[-1])
    jobs["engine"] = {"cfg": HeraldConfig.from_json(
        jcfg.to_json()).to_json(), "state": paths, "data": (d, s, y)}
    sched = JaxNative(s, nrank=S, batch_size=B, batch_num=STEPS, epochs=1,
                      cache_size=ROWS, n_threads=1)
    sched.start()
    jst, jstats = jeng.train_epoch_assigned(jeng.init_state(0), sched, d, s,
                                            y, steps=STEPS)
    sched.close()
    refs["engine"] = (jeng, jax.tree.map(np.asarray, jst),
                      np.asarray(jstats["loss"]), s)

    _, aff, _ = synthetic_ctr_data(spec, S * AFF_B * AFF_STEPS, seed=0,
                                   num_rows=AFF_ROWS, session_len=16)
    aff = aff[np.random.default_rng(1).permutation(len(aff))]
    jobs["affinity"] = {"sparse": aff}
    gb = S * AFF_B
    refs["affinity"] = [len(np.unique(aff[t * gb:(t + 1) * gb]
                                      [z * AFF_B:(z + 1) * AFF_B]))
                        for t in range(AFF_STEPS) for z in range(S)]
    torch.save(jobs, out / "jobs.pt")
    return refs


def _run(S, tmp_path_factory):
    out = tmp_path_factory.mktemp(f"assigned{S}")
    refs = _jobs(S, out)
    run_ranks(_assigned_rank, S, out, out, timeout=240)
    return S, refs, [torch.load(out / f"r{r}.pt", weights_only=False)
                     for r in range(S)]


@pytest.fixture(scope="module")
def assigned2(tmp_path_factory):
    return _run(2, tmp_path_factory)


@pytest.fixture(scope="module")
def assigned4(tmp_path_factory):
    return _run(4, tmp_path_factory)


@pytest.fixture(params=[2, 4], ids=lambda s: f"S{s}")
def assigned(request):
    return request.getfixturevalue(f"assigned{request.param}")


# ---------------------------------------------------------------------------
def test_broadcast_assignments_equal_jax_native_scheduler(assigned):
    S, refs, res = assigned
    want = refs["sched"]
    # the native scheduler plans one lookahead batch beyond the epoch
    assert len(want) == STEPS + 1
    for r in range(S):
        got = res[r]["sched"]["pops"]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == (S, B) and a.dtype == np.int64
            np.testing.assert_array_equal(a, b)


def test_broadcast_scheduler_perf_and_iter_time(assigned):
    """Every rank reads rank 0's counters; the planning time is rank 0's
    alone, 0 elsewhere, as in JAX."""
    S, _, res = assigned
    first = res[0]["sched"]
    assert set(first["perf"]) == {"miss_pull", "miss_push", "update_pull",
                                  "update_push"}
    assert first["perf"]["miss_pull"] > 0 and first["iter_time_us"] >= 0
    for r in range(1, S):
        assert res[r]["sched"]["perf"] == first["perf"]
        assert res[r]["sched"]["iter_time_us"] == 0


def test_assigned_matches_baseline_global_batch(assigned):
    """`tests/test_assigned.py`'s invariant over S ranks: the same global
    batch set each step, so the plain run's losses and final model."""
    S, _, res = assigned
    plain = [r["engine"]["plain"] for r in res]
    asgn = [r["engine"]["assigned"] for r in res]
    for p, a in zip(plain, asgn):
        np.testing.assert_allclose(a["losses"], p["losses"], rtol=1e-5)
        assert a["overflow"] == p["overflow"] == [0] * STEPS
    sp = join_states([TrainState(**p["state"]) for p in plain])
    sa = join_states([TrainState(**a["state"]) for a in asgn])
    for k in sp.dense:
        np.testing.assert_allclose(sa.dense[k], sp.dense[k], rtol=1e-4,
                                   atol=1e-6)
    np.testing.assert_allclose(sa.table, sp.table, rtol=1e-3, atol=1e-5)


def test_rank_r_trains_assignment_row_r(assigned):
    S, refs, res = assigned
    sparse = refs["engine"][3]
    for r in range(S):
        a = res[r]["engine"]["assigned"]
        assert len(a["pops"]) == STEPS
        want = np.stack([sparse[p[r]] for p in a["pops"]])
        np.testing.assert_array_equal(a["ids"], want.astype(np.int32))
    for t in range(STEPS):      # one global batch set, split by the rows
        np.testing.assert_array_equal(res[0]["engine"]["assigned"]["pops"][t],
                                      refs["sched"][t])


def test_assigned_matches_jax_assigned(assigned):
    S, refs, res = assigned
    jeng, want, losses, _ = refs["engine"]
    for r in range(S):
        np.testing.assert_allclose(res[r]["engine"]["assigned"]["losses"],
                                   losses, rtol=0, atol=1e-6)
    st = join_states([TrainState(**r["engine"]["assigned"]["state"])
                      for r in res])
    np.testing.assert_allclose(jeng.exchange.to_logical(st.table),
                               jeng.exchange.to_logical(want.table),
                               rtol=0, atol=1e-5)
    for k in want.dense:
        np.testing.assert_allclose(st.dense[k], want.dense[k], rtol=0,
                                   atol=1e-5)


def test_affinity_reduces_uniques_on_shuffled_sessions(assigned):
    """`tests/test_assigned.py`'s affinity test over the broadcast pops:
    each rank's batches hold fewer unique ids than contiguous batching
    gives on the same shuffled sessionized stream."""
    S, refs, res = assigned
    u_asgn = [u for r in res for u in r["affinity"]["uniques"]]
    assert len(u_asgn) >= S * AFF_STEPS
    assert np.mean(refs["affinity"]) / np.mean(u_asgn) > 1.03


def test_launcher_assign_only_under_torch_distributed_run(tmp_path):
    """`tests/test_assigned.py::test_cli_assign_only_mode` over 2 ranks:
    `python -m torch.distributed.run --nproc-per-node 2 -m
    herald_tpu_torch.launch --comm hybrid --assign-only --device cpu`;
    rank 0 alone prints the report."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "herald_tpu_torch.launch",
           *LAUNCH, "--comm", "hybrid", "--device", "cpu", "--assign-only"]
    p = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=180)
    assert p.returncode == 0, p.stderr[-3000:]
    rep = json.loads(p.stdout[p.stdout.index("{\n"):])
    assert p.stdout.count('"mode": "assigned"') == 1
    assert (rep["devices"], rep["backend"], rep["mode"]) == \
        (2, "gloo", "assigned")
    assert rep["steps"] == 768 // 32 and rep["overflow_rows"] == 0
    assert rep["sched"]["miss_pull"] >= 0 and rep["sched"]["plan_time_us"] >= 0
