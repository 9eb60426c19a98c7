"""The port's FAE engine over S ranks (`FaeEngine(comm_mode="hybrid")`:
the cold table row-sharded over a gloo group of S CPU ranks,
`tests/_ranks.py`, the hot block replicated) against herald_tpu's hybrid
FaeEngine on the first S of the 8 CPU devices, and its launcher branch
under `torch.distributed.run`.

Each S runs its ranks once (`_fae_rank`, torch only; JAX runs in the
test process), over jobs the test process prepares. Every training job
starts both packages from one JAX `FaeTrainState` (its physical table
split into the ranks' blocks by `bridge.shard_state`, the hot block whole
to every rank) and runs the same global batches (`batch_size * S` rows)
through `train_step_fae`:
- trains (S = 2, 4): `tests/test_fae.py::test_fae_trains[hybrid]`'s run
  (wdl_criteo, batch 8 a rank, lr 2.0, 5% of 2,000 rows hot), one epoch of
  its 2,048 samples, then `evaluate_fae` over them;
- adam (S = 2): wdl_criteo under adam at lr 0.01, 6 steps, so that the
  table slots and the f32 hot slots move;
- bf16 (S = 2): wdl_criteo, SGD, a bf16 table: the cold sums cross the
  wire in f32 and are cast on the owner, as JAX's are;
- avazu (S = 2): fae_dfm_avazu (the FM tower), SGD at lr 0.01, 6 steps;
- tight (S = 2, 4): a2a_capacity_factor 0.25, so that the exchange drops
  cold ids: the overflow counts equal JAX's step by step (the same ids
  drop in both) and the losses still agree; the port's `evaluate_fae`
  raises on the eval exchange's overflow, where JAX's reads through the
  training exchange and scores the dropped ids on zero rows (ROADMAP
  queue 3);
- dsync (S = 4): dense_sync_group 2, dense_sync_every 4, which the FAE
  step syncs after every step (warned once), against JAX's;
- init (S = 2, 4): each rank's `init_fae_state(3)` against the one-device
  engine's: its strided rows of the table and the hot block, bit for bit;
- minus_one (S = 2): the exchange read of cold ids that are -1 at hot
  positions: those positions read zero rows, the -1 entry of the dedup
  is routed to no rank and counts no overflow.

Tolerances, with the largest differences measured here: losses within
rtol 1e-5 (measured 1.0e-6 over trains' 128 steps at lr 2.0 at S = 2,
8.6e-8 at S = 4) and overflow counts equal; f32 cold table, hot block,
table slots and SGD dense params within 1e-5 (measured 3.3e-7), the
one-device file's bound; under adam the dense params within 1e-4 with
at most 0.1% beyond 1e-5 (measured 2.1e-5) and the f32 hot slots within
1e-5 of their largest value (4.8e-7); the bf16 table and hot block
within one bf16 ulp of the value plus 2^-13 (measured bit-exact); AUC
and accuracy within 1e-4. The hot block and hot slots are bit-identical
on every rank. JAX's `psum` and gloo's all-reduce may add the ranks' hot
sums in other orders at S = 4, which the f32 tolerances above cover
(measured 1.5e-8 on the hot block).
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
from herald_tpu_torch.train import engine as E
from herald_tpu_torch.train.fae import FaeEngine, FaeTrainState, build_hot_lut

REPO = Path(__file__).resolve().parents[1]
ROWS, HOT_RATE = 2000, 0.05
# name: (model, optimizer, table dtype, lr, batch a rank, steps, S values)
CASES = {
    "trains": ("wdl_criteo", "sgd", "f32", 2.0, 8, None, (2, 4)),
    "adam": ("wdl_criteo", "adam", "f32", 0.01, 8, 6, (2,)),
    "bf16": ("wdl_criteo", "sgd", "bf16", 0.01, 8, 6, (2,)),
    "avazu": ("fae_dfm_avazu", "sgd", "f32", 0.01, 8, 6, (2,)),
    "tight": ("wdl_criteo", "sgd", "f32", 0.1, 16, 6, (2, 4)),
    "dsync": ("wdl_criteo", "sgd", "f32", 0.5, 8, 8, (4,)),
}
TIGHT_FACTOR = 0.25
INIT_ROWS, INIT_CHUNK = 1001, 333
LAUNCH = ["--model", "fae_wdl_criteo", "--batch-size", "8",
          "--embedding-size", "8", "--samples", "800", "--rows", "1500",
          "--val-ratio", "0.2", "--seed", "5", "--lr", "0.5"]


def _f32(a):
    """A host array of either package as f32 (bf16 as `V2` bits or
    ml_dtypes)."""
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
def _train_job(job):
    import warnings
    eng = FaeEngine(HeraldConfig.from_json(job["cfg"]), table_rows=ROWS,
                    hot_rate=HOT_RATE, device="cpu")
    st = FaeTrainState(**torch.load(job["state"][eng.rank],
                                    weights_only=False))
    d, s, y = job["data"]
    lut = job["lut"]
    gb = eng.cfg.batch_size * eng.num_shards
    losses, overflow = [], []
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        for t in range(job["steps"]):
            z = slice(t * gb, (t + 1) * gb)
            st, stats = eng.train_step_fae(st, lut, d[z], s[z], y[z])
            losses.append(float(stats["loss"]))
            overflow.append(int(stats["overflow"]))
    res = {"losses": losses, "overflow": overflow,
           "warnings": [str(w.message) for w in warned],
           "state": state_to_numpy(st)._asdict()}
    try:
        res["eval"] = eng.evaluate_fae(st, lut, d, s, y)
    except RuntimeError as e:
        res["eval_error"] = str(e)
    return res


def _init_job(job):
    E.INIT_CHUNK_ROWS = INIT_CHUNK
    eng = FaeEngine(HeraldConfig.from_json(job["cfg"]), table_rows=INIT_ROWS,
                    device="cpu")
    return {"state": state_to_numpy(eng.init_fae_state(3))._asdict()}


def _minus_one_job(job):
    """The exchange read of ids that are -1 at hot positions."""
    eng = FaeEngine(HeraldConfig.from_json(job["cfg"]), table_rows=ROWS,
                    hot_rate=HOT_RATE, device="cpu")
    st = eng.init_fae_state(0)
    ids = torch.as_tensor(eng._rank_block(job["ids"], np.int32))
    emb, uniq, inv, route = eng._sparse_read(st.table, ids, eng.exchange)
    flat = ids.reshape(-1)
    sent = int((route.recv_ids >= 0).sum())
    sent = int(eng.comm.all_reduce_(torch.tensor([sent])).item())
    return {"hot_rows": emb.reshape(-1, eng.width)[flat < 0].numpy(),
            "cold_rows": emb.reshape(-1, eng.width)[flat >= 0].numpy(),
            "uniq0": int(uniq[0]), "valid": int((uniq >= 0).sum()),
            "minus_one_pos": int(route.pos[0]),
            "no_slot": eng.exchange.num_shards * eng.exchange.capacity,
            "overflow": int(route.overflow), "received_total": sent}


def _fae_rank(rank, S, init, out):
    torch.set_num_threads(1)
    C.setup("cpu", init_method=init, rank=rank, world_size=S)
    jobs = torch.load(out / "jobs.pt", weights_only=False)
    run = {"train": _train_job, "init": _init_job,
           "minus_one": _minus_one_job}
    res = {name: run[job["kind"]](job) for name, job in jobs.items()}
    torch.save(res, out / f"r{rank}.pt")


# ---------------------------------------------------------------------------
# the jobs and the references, in the test process
# ---------------------------------------------------------------------------
def _jax_cfg(model, opt, dt, lr, b, **kw):
    import jax.numpy as jnp
    from herald_tpu import HeraldConfig as JaxConfig
    return JaxConfig(model=model, batch_size=b, embedding_dim=8,
                     comm_mode="hybrid", optimizer=opt, learning_rate=lr,
                     table_dtype={"f32": jnp.float32,
                                  "bf16": jnp.bfloat16}[dt], **kw)


def _jax_engine(jcfg, S):
    import jax
    from jax.sharding import Mesh
    from herald_tpu.train.fae import FaeEngine as JaxFaeEngine
    mesh = Mesh(np.array(jax.devices()[:S]), ("dp",))
    return JaxFaeEngine(jcfg, mesh=mesh, table_rows=ROWS, hot_rate=HOT_RATE)


def _numpy_state(jst):
    import jax
    return jax.tree.map(np.asarray, jst)


def _train_case(S, name, out):
    model, opt, dt, lr, b, steps, _ = CASES[name]
    kw = {"a2a_capacity_factor": TIGHT_FACTOR} if name == "tight" else {}
    if name == "dsync":
        kw = {"dense_sync_group": 2, "dense_sync_every": 4}
    jcfg = _jax_cfg(model, opt, dt, lr, b, **kw)
    jeng = _jax_engine(jcfg, S)
    jst = jeng.init_fae_state(0)
    leaves = _numpy_state(jst)
    gb = b * S
    n = 2048 if steps is None else gb * steps
    steps = steps or n // gb
    d, s, y = synthetic_ctr_data(get_model(model).spec, n, seed=12,
                                 num_rows=ROWS)
    lut, _ = build_hot_lut(s, ROWS, num_hot=jeng.num_hot)
    paths = []
    for r in range(S):
        paths.append(out / f"{name}.r{r}.pt")
        torch.save(shard_state(leaves, jeng.exchange, r, "cpu")._asdict(),
                   paths[-1])
    job = {"kind": "train", "cfg": HeraldConfig.from_json(
        jcfg.to_json()).to_json(), "state": paths, "steps": steps,
        "data": (d, s, y), "lut": lut}
    losses, overflow = [], []
    for t in range(steps):
        z = slice(t * gb, (t + 1) * gb)
        jst, st = jeng.train_step_fae(jst, lut, d[z], s[z], y[z])
        losses.append(float(st["loss"]))
        overflow.append(int(np.asarray(st["overflow"]).sum()))
    ref = {"engine": jeng, "state": _numpy_state(jst), "losses": losses,
           "overflow": overflow, "eval": jeng.evaluate_fae(jst, lut, d, s, y)}
    return job, ref


def _jobs(S, out):
    jobs, refs = {}, {}
    for name, case in CASES.items():
        if S in case[-1]:
            jobs[name], refs[name] = _train_case(S, name, out)
    icfg = dict(model="fae_wdl_criteo", batch_size=8, embedding_dim=8,
                optimizer="adam", embed_optimizer="adam")
    jobs["init"] = {"kind": "init", "cfg": HeraldConfig(
        **icfg, comm_mode="hybrid").to_json()}
    chunk = E.INIT_CHUNK_ROWS
    E.INIT_CHUNK_ROWS = INIT_CHUNK
    try:
        one = FaeEngine(HeraldConfig(**icfg), table_rows=INIT_ROWS,
                        device="cpu")
        refs["init"] = state_to_numpy(one.init_fae_state(3))
    finally:
        E.INIT_CHUNK_ROWS = chunk
    if S == 2:
        _, s, _ = synthetic_ctr_data(get_model("wdl_criteo").spec, 64,
                                     seed=4, num_rows=ROWS)
        lut, _ = build_hot_lut(s, ROWS, num_hot=int(ROWS * HOT_RATE))
        ids = np.where(lut[s] >= 0, -1, s).astype(np.int32)
        jobs["minus_one"] = {"kind": "minus_one", "ids": ids,
                             "cfg": HeraldConfig(
                                 model="wdl_criteo", batch_size=32,
                                 embedding_dim=8,
                                 comm_mode="hybrid").to_json()}
        refs["minus_one"] = ids
    torch.save(jobs, out / "jobs.pt")
    return refs


def _run(S, tmp_path_factory):
    """(S, the references, [each rank's results])."""
    out = tmp_path_factory.mktemp(f"fae{S}")
    refs = _jobs(S, out)
    run_ranks(_fae_rank, S, out, out, timeout=240)
    return S, refs, [torch.load(out / f"r{r}.pt", weights_only=False)
                     for r in range(S)]


@pytest.fixture(scope="module")
def fae2(tmp_path_factory):
    return _run(2, tmp_path_factory)


@pytest.fixture(scope="module")
def fae4(tmp_path_factory):
    return _run(4, tmp_path_factory)


@pytest.fixture(params=[2, 4], ids=lambda s: f"S{s}")
def fae(request):
    return request.getfixturevalue(f"fae{request.param}")


def _joined(res, name):
    return join_states([FaeTrainState(**r[name]["state"]) for r in res])


def _check(run, name):
    S, refs, res = run
    ref = refs[name]
    model, opt, dt, lr, _, _, _ = CASES[name]
    for r in range(S):
        got = res[r][name]
        assert got["overflow"] == ref["overflow"]
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=1e-5 if dt == "f32" else 2e-5)
    st, want = _joined(res, name), ref["state"]
    ex = ref["engine"].exchange
    assert int(st.step) == int(want.step) == len(ref["losses"])
    if dt == "bf16":
        tab = dict(rtol=2.0 ** -7, atol=2.0 ** -13)
    else:
        tab = dict(rtol=0, atol=1e-5)
    pairs = [(ex.to_logical(st.table), ex.to_logical(want.table)),
             (st.hot_table, want.hot_table)]
    pairs += [(ex.to_logical(st.table_slots[k]),
               ex.to_logical(want.table_slots[k]))
              for k in want.table_slots]
    for got, exp in pairs:
        np.testing.assert_allclose(_f32(got), _f32(exp), **tab)
    for k in want.hot_slots:
        exp = np.asarray(want.hot_slots[k])
        scale = max(float(np.abs(exp).max()), 1e-30)
        np.testing.assert_allclose(st.hot_slots[k], exp, rtol=0,
                                   atol=1e-5 * scale)
    for k in want.dense:
        got, exp = st.dense[k], np.asarray(want.dense[k])
        if opt == "sgd":
            np.testing.assert_allclose(got, exp, rtol=0, atol=1e-5)
        else:
            assert (np.abs(got - exp) > 1e-5).mean() <= 1e-3
            np.testing.assert_allclose(got, exp, rtol=0, atol=1e-4)
    return S, ref, res


# ---------------------------------------------------------------------------
def test_fae_trains_hybrid_matches_jax(fae):
    """`tests/test_fae.py::test_fae_trains[hybrid]` over S ranks: one epoch
    held step by step to JAX's hybrid FAE engine, then `evaluate_fae`."""
    S, ref, res = _check(fae, "trains")
    for r in range(S):
        ev = res[r]["trains"]["eval"]
        assert abs(ev["auc"] - ref["eval"]["auc"]) <= 1e-4
        assert abs(ev["acc"] - ref["eval"]["acc"]) <= 1e-4
        assert ev == res[0]["trains"]["eval"]
    assert ref["eval"]["auc"] > 0.6, ref["eval"]


@pytest.mark.parametrize("name", ["adam", "bf16", "avazu"])
def test_fae_hybrid_cases_match_jax(fae2, name):
    _check(fae2, name)


def test_hot_block_identical_on_every_rank(fae):
    """The hot block, its slots and the tower must stay bit-identical on
    every rank: replicas that drift apart raise no error."""
    S, _, res = fae
    for name in res[0]:
        if "losses" not in res[0][name]:
            continue
        a = res[0][name]["state"]
        for r in range(1, S):
            b = res[r][name]["state"]
            np.testing.assert_array_equal(a["hot_table"], b["hot_table"])
            for k in a["hot_slots"]:
                np.testing.assert_array_equal(a["hot_slots"][k],
                                              b["hot_slots"][k])
            for k in a["dense"]:
                np.testing.assert_array_equal(a["dense"][k], b["dense"][k])
            assert res[r][name]["losses"] == res[0][name]["losses"]


def test_overflow_counts_equal_jax_and_eval_overflow_raises(fae):
    """A tight exchange drops the same cold ids in both packages: the
    per-step overflow counts are JAX's, and so are the losses. The port's
    `evaluate_fae` reads through the eval exchange and raises on its
    overflow; JAX's reads through the training exchange and scores the
    dropped ids on zero rows (ROADMAP queue 3)."""
    S, ref, res = _check(fae, "tight")
    assert sum(ref["overflow"]) > 0, ref["overflow"]
    for r in range(S):
        assert "eval exchange overflow" in res[r]["tight"]["eval_error"]
        assert "eval" not in res[r]["tight"]
    assert 0.0 <= ref["eval"]["auc"] <= 1.0


def test_dense_sync_runs_every_step_and_warns_once(fae4):
    S, _, res = _check(fae4, "dsync")
    for r in range(S):
        warned = [w for w in res[r]["dsync"]["warnings"]
                  if "dense_sync_every > 1" in w]
        assert len(warned) == 1, res[r]["dsync"]["warnings"]


def test_init_fae_state_is_the_one_device_engines(fae):
    S, refs, res = fae
    want = refs["init"]
    for r in range(S):
        st = res[r]["init"]["state"]
        rows = np.asarray(want.table)[r::S]
        np.testing.assert_array_equal(st["table"][:len(rows)], rows)
        assert not st["table"][len(rows):].any()
        np.testing.assert_array_equal(st["hot_table"], want.hot_table)
        assert set(st["hot_slots"]) == {"m", "v"}
        for v in st["hot_slots"].values():
            assert v.dtype == np.float32 and not v.any()
        for k, v in want.dense.items():
            np.testing.assert_array_equal(st["dense"][k], v)


def test_minus_one_reads_zero_rows_and_routes_nowhere(fae2):
    S, refs, res = fae2
    ids = refs["minus_one"]
    share = float((ids < 0).mean())
    assert 0.2 < share < 0.95, share
    total_valid = 0
    for r in range(S):
        m = res[r]["minus_one"]
        assert m["uniq0"] == -1
        assert m["hot_rows"].shape[0] > 0 and not m["hot_rows"].any()
        assert m["cold_rows"].any(axis=1).all()
        assert m["minus_one_pos"] == m["no_slot"]
        assert m["overflow"] == 0
        total_valid += m["valid"]
    # every rank asked its owners for its valid unique ids and nothing more
    assert all(res[r]["minus_one"]["received_total"] == total_valid
               for r in range(S))


def test_launcher_fae_under_torch_distributed_run(tmp_path):
    """`python -m torch.distributed.run --nproc-per-node 2 -m
    herald_tpu_torch.launch --comm hybrid --model fae_wdl_criteo
    --device cpu`: rank 0 alone prints the report, over global batches."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "herald_tpu_torch.launch",
           *LAUNCH, "--comm", "hybrid", "--device", "cpu", "--log-dir",
           str(tmp_path / "logs")]
    p = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=180)
    assert p.returncode == 0, p.stderr[-3000:]
    report = json.loads(p.stdout[p.stdout.index("{\n"):])
    assert p.stdout.count('"mode": "fae"') == 1
    assert (report["devices"], report["backend"], report["mode"]) == \
        (2, "gloo", "fae")
    assert report["steps"] == 640 // 16 and report["num_hot"] == 15
    assert np.isfinite(report["train_loss_last"])
    assert np.load(tmp_path / "logs" / "losses.npy").shape == (40,)
