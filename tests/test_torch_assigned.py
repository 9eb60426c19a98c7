"""Assign-only mode on one device: the port's lookahead scheduler
(`herald_tpu_torch/sched/scheduler.py` over csrc/herald_sched.cc, built
by the port's loader), its numpy mirror, the loaders,
`Engine.train_epoch_assigned` and the launcher's `--assign-only` branch,
against herald_tpu's, on the CPU.

The scheduler is host code: the port's and the JAX package's bindings of
the same source give the same assignments, plans and counters, and are
held equal. `tests/test_scheduler.py`'s checks run on the port's copies.
The engine and the launcher start from one JAX state (a JAX checkpoint at
step 0 for the launcher), f32 tables, with `tests/test_torch_launch.py`'s
tolerances: per-epoch and final losses within 1e-5, AUC within 1e-4; the
`sched` counters are integers and equal. On one device a step trains the
plain step's samples in another order, so its losses equal the plain
run's within f32 summation order (1e-6). A run stopped at `--max-steps`
and resumed is bit-exact against the uninterrupted one.
"""

import os

import jax
import numpy as np
import pytest
import torch

from herald_tpu import HeraldConfig as JaxConfig
from herald_tpu.data import synthetic_ctr_data
from herald_tpu.data.loaders import Dataloader as JaxDataloader
from herald_tpu.data.loaders import \
    LookaheadDataloader as JaxLookaheadDataloader
from herald_tpu.launch.cli import build_parser as jax_parser
from herald_tpu.launch.cli import run_training as jax_run
from herald_tpu.models import get_model
from herald_tpu.sched.scheduler import LookaheadScheduler as JaxLookahead
from herald_tpu.sched.scheduler import NativeScheduler as JaxNative
from herald_tpu.train.checkpoint import save_checkpoint as jax_save
from herald_tpu.train.engine import Engine as JaxEngine
from herald_tpu_torch import Engine, HeraldConfig
from herald_tpu_torch.bridge import state_from_numpy
from herald_tpu_torch.data import Dataloader, LookaheadDataloader
from herald_tpu_torch.launch import cli
from herald_tpu_torch.sched import build
from herald_tpu_torch.sched.pysched import PyLruSim, PyScheduler
from herald_tpu_torch.sched.scheduler import (LookaheadScheduler,
                                              NativeScheduler)
from herald_tpu_torch.train.checkpoint import load_checkpoint

NRANK, MBS, TABLES, ROWS = 4, 8, 6, 500


def _ids(n=NRANK * MBS * 12, seed=0):
    rng = np.random.default_rng(seed)
    # zipf-ish skew so caching matters
    raw = rng.zipf(1.3, size=(n, TABLES))
    return ((raw - 1) % ROWS).astype(np.int64)


def _drain(sched):
    out = []
    while True:
        r = sched.pop()
        if r is None:
            return out
        out.append(r)


# ----------------------------------------------------------------------
# tests/test_scheduler.py, on the port's copies
# ----------------------------------------------------------------------

def test_lru_sim_return_codes():
    c = PyLruSim(2, 100)
    assert c.get(1) == 0          # miss, insert
    assert c.get(1) == -1         # hit
    assert c.get(2) == 0
    assert c.get(3) == 1          # insert, evicts fresh key 1
    assert not c.check(1)
    c.outdate(2)
    assert not c.check(2)
    assert c.get(2) == -2         # outdated hit -> update_pull
    assert c.check(2)


@pytest.mark.parametrize("nrank", [1, NRANK])
def test_native_matches_numpy_mirror(nrank):
    ids = _ids()
    batch_num = len(ids) // (nrank * MBS)
    native = NativeScheduler(ids, nrank, MBS, batch_num, epochs=1,
                             cache_size=60, n_threads=1)
    native.start()
    py = PyScheduler(ids, nrank, MBS, cache_size=60)
    for b in range(batch_num):
        got = native.pop()
        assert got is not None, f"native ended early at batch {b}"
        p_assign, p_plans = py.plan_next()
        np.testing.assert_array_equal(got[0], p_assign,
                                      err_msg=f"assign batch {b}")
        for z in range(nrank):
            np.testing.assert_array_equal(got[1][z], p_plans[z],
                                          err_msg=f"plan b{b} w{z}")
    # the native scheduler plans one lookahead batch beyond the epoch
    assert native.pop() is not None
    py.plan_next()
    assert native.pop() is None   # end of stream
    assert native.perf() == py.perf()
    native.close()


def test_assignment_is_balanced_partition():
    ids = _ids(seed=1)
    batch_num = len(ids) // (NRANK * MBS)
    native = NativeScheduler(ids, NRANK, MBS, batch_num, epochs=1,
                             cache_size=60, n_threads=2)
    native.start()
    for b in range(batch_num):
        assign, plans = native.pop()
        assert assign.shape == (NRANK, MBS)
        # exactly the global batch's samples, each once
        expect = (b * NRANK * MBS + np.arange(NRANK * MBS)) % len(ids)
        np.testing.assert_array_equal(np.sort(assign.reshape(-1)),
                                      np.sort(expect))
    native.close()


def test_affinity_beats_round_robin():
    """Assignments hit the simulated caches more often than a round-robin
    split (the numpy mirror, as tests/test_scheduler.py holds it)."""
    ids = _ids(n=NRANK * MBS * 30, seed=2)
    py = PyScheduler(ids, NRANK, MBS, cache_size=80)
    for _ in range(len(ids) // (NRANK * MBS)):
        py.plan_next()
    sched_miss = py.perf()["miss_pull"]
    rr = PyScheduler(ids, NRANK, MBS, cache_size=80)
    for b in range(len(ids) // (NRANK * MBS)):
        idx = (b * NRANK * MBS + np.arange(NRANK * MBS)) % len(ids)
        for z, row in enumerate(idx.reshape(MBS, NRANK).T):
            for k in np.unique(ids[row]):
                if rr.caches[z].get(int(k)) >= 0:
                    rr.counters["miss_pull"][z] += 1
    assert sched_miss < rr.perf()["miss_pull"]


def test_prefetch_window_serves_all_batches():
    ids = _ids(n=NRANK * MBS * 10, seed=3)
    sched = LookaheadScheduler(ids, NRANK, batch_size=MBS, cache_size=60,
                               epochs=2, queue_size=3, n_threads=2)
    seen = []
    for b in range(sched.batch_num * 2):
        assign, plans = sched.get_batch(b % sched.batch_num)
        assert assign.shape == (NRANK, MBS)
        assert len(plans) == NRANK
        seen.append(assign.copy())
        sched.step_forward()
    sched.close()
    # epoch 1 covers every sample exactly once
    first_epoch = np.concatenate([a.reshape(-1)
                                  for a in seen[:sched.batch_num]])
    np.testing.assert_array_equal(
        np.sort(first_epoch),
        np.arange(sched.batch_num * NRANK * MBS) % len(ids))


# ----------------------------------------------------------------------
# the port's binding against the JAX package's
# ----------------------------------------------------------------------

def test_scheduler_library_is_the_ports_own_build():
    path = build.sched_lib_path()
    assert os.path.dirname(path) == str(build.BUILD_DIR)
    name = os.path.basename(path)
    assert name.startswith("libherald_sched.")
    tag, value = build.abi_hash(build.SCHED_SOURCE)
    assert tag in name and tag != build.abi_hash()[0]
    assert build._lib_abi(build.BUILD_DIR / name) == value
    assert "herald_tpu/sched" not in path


@pytest.mark.parametrize("nrank,top_k,epochs", [(1, 0, 2), (NRANK, 3, 1)])
def test_native_matches_jax_binding(nrank, top_k, epochs):
    ids = _ids(seed=4)
    batch_num = len(ids) // (nrank * MBS)
    kw = dict(batch_num=batch_num, epochs=epochs, cache_size=40,
              top_k=top_k, n_threads=3)
    mine, theirs = (cls(ids, nrank, MBS, **kw) for cls in (NativeScheduler,
                                                          JaxNative))
    mine.start()
    theirs.start()
    a, b = _drain(mine), _drain(theirs)
    assert len(a) == len(b) == batch_num * epochs + 1
    for (xa, xp), (ya, yp) in zip(a, b):
        np.testing.assert_array_equal(xa, ya)
        for p, q in zip(xp, yp):
            np.testing.assert_array_equal(p, q)
    assert mine.perf() == theirs.perf()
    mine.close()
    theirs.close()


def test_lookahead_scheduler_matches_jax():
    """The sequential facade (`pop`) the launcher walks, over two epochs
    of a stream whose length is no multiple of the batch."""
    ids = _ids(n=1000, seed=5)
    kw = dict(nrank=1, batch_size=48, cache_size=100, epochs=2,
              n_threads=2)
    mine, theirs = LookaheadScheduler(ids, **kw), JaxLookahead(ids, **kw)
    assert (mine.batch_num, mine.batch_size, mine.queue_size) == \
        (theirs.batch_num, theirs.batch_size, theirs.queue_size) == (20, 48,
                                                                     5)
    a, b = _drain(mine), _drain(theirs)
    assert len(a) == len(b) == 40
    for (xa, xp), (ya, yp) in zip(a, b):
        np.testing.assert_array_equal(xa, ya)
        np.testing.assert_array_equal(xp[0], yp[0])
    assert mine.perf() == theirs.perf()
    mine.close()
    theirs.close()


def test_loaders_match_jax():
    rng = np.random.default_rng(6)
    arrays = [rng.standard_normal((203, 3)).astype(np.float32),
              _ids(n=203, seed=6), rng.integers(0, 2, (203, 1))]
    for kw in ({"batch_size": 16, "nrank": 2},
               {"batch_size": 24, "nrank": 3, "drop_last": False}):
        mine, theirs = Dataloader(arrays, **kw), JaxDataloader(arrays, **kw)
        assert mine.batch_num == theirs.batch_num
        for _ in range(mine.batch_num + 2):     # wraps around
            for x, y in zip(mine.next_batch(), theirs.next_batch()):
                np.testing.assert_array_equal(x, y)
    kw = dict(nrank=2, batch_size=16, cache_size=50, epochs=1, n_threads=2)
    s1, s2 = LookaheadScheduler(arrays[1], **kw), JaxLookahead(arrays[1],
                                                              **kw)
    mine, theirs = LookaheadDataloader(arrays, s1), \
        JaxLookaheadDataloader(arrays, s2)
    for _ in range(mine.batch_num):
        (xb, xp), (yb, yp) = mine.next_batch(), theirs.next_batch()
        for x, y in zip(xb, yb):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(xp, yp):
            np.testing.assert_array_equal(x, y)
    s1.close()
    s2.close()


# ----------------------------------------------------------------------
# Engine.train_epoch_assigned
# ----------------------------------------------------------------------

B, EROWS, STEPS = 16, 800, 10


def _engines():
    jcfg = JaxConfig(model="wdl_criteo", batch_size=B, embedding_dim=8,
                     learning_rate=0.5)
    jeng = JaxEngine(jcfg, table_rows=EROWS)
    eng = Engine(HeraldConfig.from_json(jcfg.to_json()), table_rows=EROWS,
                 device="cpu")
    return jeng, eng, jax.tree.map(np.asarray, jeng.init_state(0))


def test_train_epoch_assigned_matches_jax_and_the_plain_epoch():
    jeng, eng, leaves = _engines()
    d, s, y = synthetic_ctr_data(get_model("wdl_criteo").spec, B * STEPS,
                                 seed=9, num_rows=EROWS)
    kw = dict(nrank=1, batch_size=B, cache_size=200, epochs=1, n_threads=2)
    mine, theirs = LookaheadScheduler(s, **kw), JaxLookahead(s, **kw)
    st, stats = eng.train_epoch_assigned(state_from_numpy(leaves, "cpu"),
                                         mine, d, s, y, steps=6)
    jst, jstats = jeng.train_epoch_assigned(jeng.init_state(0), theirs, d,
                                            s, y, steps=6)
    st, more = eng.train_epoch_assigned(st, mine, d, s, y, steps=STEPS)
    jst, jmore = jeng.train_epoch_assigned(jst, theirs, d, s, y,
                                           steps=STEPS)
    # 6 + 4: the stream ends after one epoch, then nothing is left
    assert more["loss"].shape == (4,) and jmore["loss"].shape == (4,)
    after, none = eng.train_epoch_assigned(st, mine, d, s, y, steps=2)
    assert after is st and none is None
    mine.close()
    theirs.close()
    losses = torch.cat([stats["loss"], more["loss"]]).numpy()
    np.testing.assert_allclose(
        losses, np.concatenate([jstats["loss"], jmore["loss"]]), rtol=0,
        atol=1e-5)
    np.testing.assert_allclose(st.table.numpy(), np.asarray(jst.table),
                               rtol=0, atol=1e-5)
    # one device: each step's samples are the plain step's, reordered
    plain, pstats = eng.train_epoch(state_from_numpy(leaves, "cpu"), d, s,
                                    y, steps=STEPS)
    np.testing.assert_allclose(losses, pstats["loss"].numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(st.table.numpy(), plain.table.numpy(),
                               rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# the launcher's --assign-only branch
# ----------------------------------------------------------------------

LROWS = 800
COMMON = ["--model", "wdl_criteo", "--comm", "local", "--assign-only",
          "--batch-size", "16", "--samples", "1024", "--rows", str(LROWS),
          "--embedding-size", "8", "--lr", "0.5", "--scan-steps", "4",
          "--val-ratio", "0.25", "--cache-limit-ratio", "0.6", "--seed", "5"]


def _port(argv):
    return cli.run_training(cli.build_parser().parse_args(
        COMMON + ["--device", "cpu"] + argv))


def test_cli_assign_only_mode():
    """`tests/test_assigned.py::test_cli_assign_only_mode` on the port."""
    rep = _port(["--nepoch", "1"])
    assert rep["mode"] == "assigned"
    assert rep["steps"] == 768 // 16 and rep["overflow_rows"] == 0
    assert "sched" in rep and rep["sched"]["miss_pull"] > 0
    assert set(rep["sched"]) == {"miss_pull", "miss_push", "update_pull",
                                 "update_push", "plan_time_us"}
    assert np.isfinite(rep["train_loss_last"]) and rep["val_auc"] is not None


def test_assign_only_launcher_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("HERALD_COMPILE_CACHE", "")
    cfg = JaxConfig(model="wdl_criteo", batch_size=16, embedding_dim=8,
                    learning_rate=0.5, seed=5)
    jax_save(JaxEngine(cfg, table_rows=LROWS).init_state(5),
             str(tmp_path / "init"))
    argv = ["--nepoch", "2", "--resume", str(tmp_path / "init")]
    port = _port(argv)
    jx = jax_run(jax_parser().parse_args(COMMON + ["--no-prefetch"] + argv))
    assert port["mode"] == jx["mode"] == "assigned"
    assert set(port) == set(jx) | {"device"}
    assert port["steps"] == jx["steps"] == 2 * (768 // 16)
    assert port["stopped_early"] == jx["stopped_early"] is False
    assert port["overflow_rows"] == jx["overflow_rows"] == 0
    ps, js = dict(port["sched"]), dict(jx["sched"])
    ps.pop("plan_time_us"), js.pop("plan_time_us")
    assert ps == js and ps["miss_pull"] > 0
    assert abs(port["train_loss_last"] - jx["train_loss_last"]) <= 1e-5
    assert abs(port["val_auc"] - jx["val_auc"]) <= 1e-4
    assert len(port["epochs"]) == len(jx["epochs"]) == 2
    for a, b in zip(port["epochs"], jx["epochs"]):
        assert a["epoch"] == b["epoch"]
        assert abs(a["train_loss"] - b["train_loss"]) <= 1e-5
        assert abs(a["val_auc"] - b["val_auc"]) <= 1e-4


def test_assign_only_resume_is_bit_exact(tmp_path):
    common = ["--nepoch", "2", "--bf16-table"]
    whole = _port(common + ["--ckpt", str(tmp_path / "whole")])
    first = _port(common + ["--ckpt", str(tmp_path / "part"),
                            "--ckpt-every", "20", "--max-steps", "70"])
    assert first["steps"] == 70 and first["stopped_early"]
    assert [e["epoch"] for e in first["epochs"]] == [0]
    rest = _port(common + ["--resume", str(tmp_path / "part"), "--ckpt",
                           str(tmp_path / "rest")])
    assert rest["steps"] == whole["steps"] - 70 == 26
    assert rest["val_auc"] == whole["val_auc"]
    a = load_checkpoint(str(tmp_path / "whole"), "cpu")
    b = load_checkpoint(str(tmp_path / "rest"), "cpu")
    assert int(a.step) == int(b.step) == whole["steps"]
    assert a.table.dtype == torch.bfloat16 and torch.equal(a.table, b.table)
    assert all(torch.equal(a.dense[k], b.dense[k]) for k in a.dense)
