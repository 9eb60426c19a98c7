"""The port's hybrid engine (`Engine(comm_mode="hybrid")`: the table
row-sharded over a gloo group of S CPU ranks, `tests/_ranks.py`) and its
launcher, against the port's local engine and herald_tpu's hybrid engine.

Each S runs its ranks once (`_hybrid_rank`, torch only; JAX is imported
in the test bodies), over jobs the test process prepares:
- parity (S = 2, 4): tests/test_parity.py's assertion, the hybrid engine
  (`train_step`, batch 16 a rank) from the local engine's state against
  the local engine over the same global batches, 5 steps: losses within
  rtol 1e-5, the logical table and the dense params within rtol 1e-4,
  atol 1e-6, overflow 0.
- jax (S = 2, and wdl SGD at S = 4): from one JAX hybrid state (its
  physical table split into the ranks' blocks by `bridge.shard_state`),
  5 `train_epoch` steps of each package's hybrid engine; wdl_criteo and
  dfm_criteo (embedding 8), SGD and adam, f32 tables, and wdl SGD with a
  bf16 table. The tolerances of `tests/test_torch_train.py`, for the
  same reasons: f32 losses within 1e-6, logical table, dense params and
  slots within 1e-5; bf16 losses within 1e-5 and the table within 2^-7
  of the value plus 2^-13. Overflow counts equal. dfm's adam runs at lr
  1e-3, as there.
- eval (S = 2, 4): `predict` (every rank returns the global batch's
  probabilities) and `evaluate` (whole global batches, and batches of 16
  rows) against JAX's from the trained state: probabilities within atol
  1e-6, AUC and accuracy within 1e-4 (`tests/test_torch_engine.py`); an
  eval exchange too small for the batch raises in both packages.
- dsync (S = 4, global batch 128 as tests/test_dsync.py's): its cases
  that need no HLO, on the port alone.
- init (S = 2, 4): every rank's `init_state` (adam, so the table has
  slots; 4,001 rows drawn in chunks of 999) joined into the physical
  layout equals the local engine's `init_state` laid out so, bit for bit:
  one seed gives one logical table and tower at every S.
The launcher runs `--comm hybrid` on 2 ranks against herald_tpu.launch on
a 2-device mesh from one JAX state, with the tolerances of
`tests/test_torch_launch.py`, and once under `torch.distributed.run`.
"""

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
from herald_tpu_torch.parallel.exchange import make_exchange
from herald_tpu_torch.train import engine as E
from herald_tpu_torch.train.engine import Engine, TrainState

REPO = Path(__file__).resolve().parents[1]
ROWS, B, STEPS = 4096, 16, 5
# (model, optimizer, table dtype, lr) against JAX, at S = 2
JAX_CASES = [("wdl_criteo", "sgd", "f32", 0.01),
             ("wdl_criteo", "adam", "f32", 0.01),
             ("dfm_criteo", "sgd", "f32", 0.01),
             ("dfm_criteo", "adam", "f32", 1e-3),
             ("wdl_criteo", "sgd", "bf16", 0.01)]
DSYNC_ROWS, DSYNC_GB = 3000, 128
INIT_ROWS, INIT_CHUNK = 4001, 999
LAUNCH = ["--model", "wdl_criteo", "--batch-size", "16",
          "--embedding-size", "8", "--samples", "1600", "--rows", "3000",
          "--val-ratio", "0.2", "--scan-steps", "8", "--seed", "5"]


def _case_name(case):
    return "-".join(str(c) for c in case)


def _data(model, n, seed, rows):
    return synthetic_ctr_data(get_model(model).spec, n, seed=seed,
                              num_rows=rows)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
def _state_file(job, rank):
    return TrainState(**torch.load(job["states"][rank], weights_only=False))


def _train_job(job, rank):
    eng = Engine(HeraldConfig.from_json(job["cfg"]), table_rows=job["rows"],
                 device="cpu")
    st = _state_file(job, rank)
    d, s, y = job["data"]
    gb = eng.cfg.batch_size * eng.num_shards
    if job["entry"] == "train_step":
        losses, overflow = [], []
        for t in range(job["steps"]):
            z = slice(t * gb, (t + 1) * gb)
            st, stats = eng.train_step(st, d[z], s[z], y[z])
            losses.append(float(stats["loss"]))
            overflow.append(int(stats["overflow"]))
    else:
        st, stats = eng.train_epoch(st, d, s, y, steps=job["steps"])
        losses = stats["loss"].tolist()
        overflow = stats["overflow"].tolist()
    res = {"losses": losses, "overflow": overflow,
           "state": state_to_numpy(st)._asdict()}
    if job.get("eval"):
        res["predict"] = eng.predict(st, d[:gb], s[:gb]).numpy()
        res["evaluate"] = eng.evaluate(st, d, s, y)
        res["evaluate16"] = eng.evaluate(st, d, s, y, batch=16)
        tight = Engine(HeraldConfig.from_json(job["tight_cfg"]),
                       table_rows=job["rows"], device="cpu")
        try:
            tight.predict(st, d[:gb], s[:gb])
        except RuntimeError as e:
            res["tight_error"] = str(e)
    return res


def _dsync_job(job, rank, S):
    d, s, y = job["data"]
    base = dict(model="wdl_criteo", batch_size=DSYNC_GB // S,
                embedding_dim=8, comm_mode="hybrid", learning_rate=0.5,
                a2a_capacity_factor=8.0)
    res = {}

    def run(steps, **kw):
        eng = Engine(HeraldConfig(**{**base, **kw}), table_rows=DSYNC_ROWS,
                     device="cpu")
        st, stats = eng.train_epoch(eng.init_state(0), d, s, y, steps=steps)
        assert int(stats["overflow"].sum()) == 0
        return eng, st

    def dense(st):
        return torch.cat([v.reshape(-1) for v in st.dense.values()]).numpy()

    eng, st = run(8)
    res["default_on"] = eng._dsync_on
    res["bsp"], res["bsp_table"] = dense(st), st.table.numpy()
    eng, st = run(8, dense_sync_every=1, dense_sync_group=S)
    res["full_on"], res["full"] = eng._dsync_on, dense(st)
    with pytest.warns(UserWarning, match="MORE collective bytes"):
        _, st = run(8, dense_sync_every=1, dense_sync_group=1)
    res["local"], res["local_table"] = dense(st), st.table.numpy()
    _, st = run(24)
    res["bsp24"] = dense(st)
    eng, st = run(24, dense_sync_every=4, dense_sync_group=1)
    res["k4"] = dense(st)
    st = eng.init_state(0)
    for _ in range(3):
        st, _ = eng.train_epoch(st, d, s, y, steps=24)
    res["k4_eval"] = eng.evaluate(st, d, s, y)
    for g in (3, 2 * S):
        try:
            Engine(HeraldConfig(**{**base, "dense_sync_group": g}),
                   table_rows=DSYNC_ROWS, device="cpu")
        except ValueError as e:
            res[f"group{g}"] = str(e)
    return res


def _init_job(job):
    E.INIT_CHUNK_ROWS = INIT_CHUNK
    eng = Engine(HeraldConfig.from_json(job["cfg"]), table_rows=INIT_ROWS,
                 device="cpu")
    return {"state": state_to_numpy(eng.init_state(3))._asdict()}


def _hybrid_rank(rank, S, init, out):
    torch.set_num_threads(1)
    C.setup("cpu", init_method=init, rank=rank, world_size=S)
    jobs = torch.load(out / "jobs.pt", weights_only=False)
    run = {"dsync": lambda job: _dsync_job(job, rank, S),
           "init": _init_job, "train": lambda job: _train_job(job, rank)}
    res = {name: run[job["kind"]](job) for name, job in jobs.items()}
    torch.save(res, out / f"r{rank}.pt")


# ---------------------------------------------------------------------------
# the jobs and the references, in the test process
# ---------------------------------------------------------------------------
def _jax_hybrid(S, model, opt, dt, lr, **kw):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from herald_tpu import HeraldConfig as JaxConfig
    from herald_tpu.train.engine import Engine as JaxEngine
    jcfg = JaxConfig(model=model, batch_size=B, embedding_dim=8,
                     comm_mode="hybrid", optimizer=opt, learning_rate=lr,
                     table_dtype={"f32": jnp.float32,
                                  "bf16": jnp.bfloat16}[dt],
                     a2a_capacity_factor=8.0, **kw)
    mesh = Mesh(np.array(jax.devices()[:S]), ("dp",))
    return jcfg, JaxEngine(jcfg, mesh=mesh, table_rows=ROWS)


def _numpy_state(jst):
    import jax
    return jax.tree.map(np.asarray, jst)


def _save_rank_states(out, name, states):
    paths = []
    for r, st in enumerate(states):
        paths.append(out / f"{name}.r{r}.pt")
        torch.save(st._asdict(), paths[-1])
    return paths


def _jobs(S, out):
    jobs, refs = {}, {}
    # parity with the port's local engine
    d, s, y = _data("wdl_criteo", S * B * STEPS, 3, ROWS)
    local = Engine(HeraldConfig(model="wdl_criteo", batch_size=S * B,
                                embedding_dim=8, learning_rate=0.1),
                   table_rows=ROWS, device="cpu")
    hcfg = HeraldConfig(model="wdl_criteo", batch_size=B, embedding_dim=8,
                        comm_mode="hybrid", learning_rate=0.1,
                        a2a_capacity_factor=8.0)
    spec = make_exchange(ROWS, S, B * 26, 8.0)
    sl = local.init_state(0)
    states = [TrainState(table=spec.block_of(sl.table, r), table_slots={},
                         dense={k: v.clone() for k, v in sl.dense.items()},
                         dense_slots={k: {} for k in sl.dense},
                         step=sl.step.clone()) for r in range(S)]
    jobs["parity"] = {"kind": "train", "entry": "train_step",
                      "cfg": hcfg.to_json(), "rows": ROWS, "steps": STEPS,
                      "data": (d, s, y),
                      "states": _save_rank_states(out, "parity", states)}
    losses = []
    for t in range(STEPS):
        z = slice(t * S * B, (t + 1) * S * B)
        sl, stats = local.train_step(sl, d[z], s[z], y[z])
        losses.append(float(stats["loss"]))
    refs["parity"] = (losses, sl, spec)

    # against JAX's hybrid engine from one state
    for case in (JAX_CASES if S == 2 else JAX_CASES[:1]):
        model, opt, dt, lr = case
        jcfg, jeng = _jax_hybrid(S, model, opt, dt, lr)
        jst = jeng.init_state(0)
        leaves = _numpy_state(jst)
        data = _data(model, S * B * STEPS, 11, ROWS)
        name = "jax-" + _case_name(case)
        jobs[name] = {
            "kind": "train", "entry": "train_epoch",
            "cfg": HeraldConfig.from_json(jcfg.to_json()).to_json(),
            "rows": ROWS, "steps": STEPS, "data": data,
            "eval": case == JAX_CASES[0],
            "tight_cfg": HeraldConfig.from_json(jcfg.to_json().replace(
                '"a2a_capacity_factor": 8.0',
                '"a2a_capacity_factor": 0.05')).to_json(),
            "states": _save_rank_states(out, name, [
                shard_state(leaves, jeng.exchange, r, "cpu")
                for r in range(S)])}
        jst, stats = jeng.train_epoch(jst, *data, steps=STEPS)
        refs[name] = (jeng, jst, stats, data, jcfg)

    # one logical table at every S
    icfg = dict(model="wdl_criteo", batch_size=B, embedding_dim=8,
                optimizer="adam", embed_optimizer="adam")
    jobs["init"] = {"kind": "init", "cfg": HeraldConfig(
        **icfg, comm_mode="hybrid").to_json()}
    chunk = E.INIT_CHUNK_ROWS
    E.INIT_CHUNK_ROWS = INIT_CHUNK
    try:
        one = Engine(HeraldConfig(**icfg), table_rows=INIT_ROWS,
                     device="cpu")
        refs["init"] = (state_to_numpy(one.init_state(3)),
                        make_exchange(INIT_ROWS, S, B * 26, 2.0))
    finally:
        E.INIT_CHUNK_ROWS = chunk

    if S == 4:
        d, s, y = _data("wdl_criteo", DSYNC_GB * 24, 7, DSYNC_ROWS)
        jobs["dsync"] = {"kind": "dsync", "data": (d, s, y)}
    torch.save(jobs, out / "jobs.pt")
    return refs


def _run(S, tmp_path_factory):
    """(S, the references, [each rank's results])."""
    out = tmp_path_factory.mktemp(f"hybrid{S}")
    refs = _jobs(S, out)
    run_ranks(_hybrid_rank, S, out, out, timeout=240)
    return S, refs, [torch.load(out / f"r{r}.pt", weights_only=False)
                     for r in range(S)]


@pytest.fixture(scope="module")
def hybrid2(tmp_path_factory):
    return _run(2, tmp_path_factory)


@pytest.fixture(scope="module")
def hybrid4(tmp_path_factory):
    return _run(4, tmp_path_factory)


@pytest.fixture(params=[2, 4], ids=lambda s: f"S{s}")
def hybrid(request):
    return request.getfixturevalue(f"hybrid{request.param}")


def _joined(res, name):
    return join_states([TrainState(**r[name]["state"]) for r in res])


def _f32(a):
    """A host array of either package as f32 (bf16 as `V2` bits or
    ml_dtypes)."""
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


# ---------------------------------------------------------------------------
def test_hybrid_matches_local(hybrid):
    S, refs, res = hybrid
    losses, sl, spec = refs["parity"]
    for r in range(S):
        assert res[r]["parity"]["overflow"] == [0] * STEPS
        np.testing.assert_allclose(res[r]["parity"]["losses"], losses,
                                   rtol=1e-5)
    st = _joined(res, "parity")
    np.testing.assert_allclose(spec.to_logical(st.table),
                               sl.table.numpy()[:ROWS], rtol=1e-4, atol=1e-6)
    for r in range(S):
        for k, v in sl.dense.items():
            np.testing.assert_allclose(res[r]["parity"]["state"]["dense"][k],
                                       v.numpy(), rtol=1e-4, atol=1e-6)


def test_init_state_is_the_local_engines_at_every_s(hybrid):
    S, refs, res = hybrid
    want, spec = refs["init"]
    got = _joined(res, "init")
    assert got.table.shape == (spec.padded_rows, want.table.shape[1])
    np.testing.assert_array_equal(got.table, spec.to_physical(want.table))
    assert set(got.table_slots) == set(want.table_slots) == {"m", "v"}
    for k, v in got.table_slots.items():
        np.testing.assert_array_equal(v, spec.to_physical(
            want.table_slots[k]))
    for r in range(S):
        st = res[r]["init"]["state"]
        for k, v in want.dense.items():
            np.testing.assert_array_equal(st["dense"][k], v)
            for sk, sv in want.dense_slots[k].items():
                np.testing.assert_array_equal(st["dense_slots"][k][sk], sv)


def test_dense_params_identical_on_every_rank(hybrid):
    """Replicas that drift apart raise no error: every rank's tower and
    its slots must stay bit-identical."""
    S, _, res = hybrid
    for name in res[0]:
        if "state" not in res[0][name]:
            continue
        for r in range(1, S):
            a, b = res[0][name]["state"], res[r][name]["state"]
            for k in a["dense"]:
                np.testing.assert_array_equal(a["dense"][k], b["dense"][k])
                for sk in a["dense_slots"][k]:
                    np.testing.assert_array_equal(a["dense_slots"][k][sk],
                                                  b["dense_slots"][k][sk])
            assert res[0][name].get("losses") == res[r][name].get("losses")


def _check_jax(hybrid, case):
    S, refs, res = hybrid
    name = "jax-" + _case_name(case)
    jeng, jst, stats, _, _ = refs[name]
    bf16 = case[2] == "bf16"
    for r in range(S):
        got = res[r][name]
        assert got["overflow"] == np.asarray(stats["overflow"]).tolist()
        np.testing.assert_allclose(got["losses"], np.asarray(stats["loss"]),
                                   rtol=0, atol=1e-5 if bf16 else 1e-6)
    st = _joined(res, name)
    want = _numpy_state(jst)
    tab = dict(rtol=2.0 ** -7, atol=2.0 ** -13) if bf16 else \
        dict(rtol=0, atol=1e-5)
    np.testing.assert_allclose(_f32(jeng.exchange.to_logical(st.table)),
                               _f32(jeng.exchange.to_logical(want.table)),
                               **tab)
    for k in want.table_slots:
        np.testing.assert_allclose(
            _f32(jeng.exchange.to_logical(st.table_slots[k])),
            _f32(jeng.exchange.to_logical(want.table_slots[k])), **tab)
    for k in want.dense:
        np.testing.assert_allclose(st.dense[k], want.dense[k], rtol=0,
                                   atol=1e-5)
        for sk in want.dense_slots[k]:
            np.testing.assert_allclose(st.dense_slots[k][sk],
                                       want.dense_slots[k][sk], rtol=0,
                                       atol=1e-5)
    assert int(st.step) == int(want.step) == STEPS


@pytest.mark.parametrize("case", JAX_CASES, ids=_case_name)
def test_hybrid_matches_jax_hybrid(hybrid2, case):
    _check_jax(hybrid2, case)


def test_hybrid_matches_jax_hybrid_on_four_ranks(hybrid4):
    _check_jax(hybrid4, JAX_CASES[0])


def test_predict_and_evaluate_match_jax(hybrid):
    S, refs, res = hybrid
    name = "jax-" + _case_name(JAX_CASES[0])
    jeng, jst, _, (d, s, y), jcfg = refs[name]
    gb = B * S
    want = np.asarray(jeng.predict(jst, d[:gb], s[:gb]))
    for r in range(S):
        got = res[r][name]
        assert got["predict"].shape == (gb,)
        np.testing.assert_allclose(got["predict"], want, rtol=0, atol=1e-6)
        for key, batch in (("evaluate", None), ("evaluate16", 16)):
            w = jeng.evaluate(jst, d, s, y, batch=batch)
            assert abs(got[key]["auc"] - w["auc"]) <= 1e-4
            assert abs(got[key]["acc"] - w["acc"]) <= 1e-4
        assert "eval exchange overflow" in got["tight_error"]
    # the same tight exchange overflows in JAX
    import jax
    from jax.sharding import Mesh
    from herald_tpu.train.engine import Engine as JaxEngine
    tight = JaxEngine(type(jcfg)(**{**jcfg.__dict__,
                                    "a2a_capacity_factor": 0.05}),
                      mesh=Mesh(np.array(jax.devices()[:S]), ("dp",)),
                      table_rows=ROWS)
    with pytest.raises(RuntimeError, match="eval exchange overflow"):
        tight.predict(jst, d[:gb], s[:gb])


def _dsync(hybrid4):
    S, _, res = hybrid4
    return S, [r["dsync"] for r in res]


def test_dsync_defaults_are_exact_bsp(hybrid4):
    _, res = _dsync(hybrid4)
    assert not res[0]["default_on"]


def test_dsync_config_validation(hybrid4):
    S, res = _dsync(hybrid4)
    with pytest.raises(ValueError, match="hybrid"):
        HeraldConfig(comm_mode="local", dense_sync_every=4)
    with pytest.raises(ValueError, match="dp-only"):
        HeraldConfig(comm_mode="hybrid", mp_shards=2, dense_sync_group=1)
    for r in res:
        assert "divide" in r["group3"]
        assert "exceeds" in r[f"group{2 * S}"]


def test_dsync_full_group_every1_equals_bsp(hybrid4):
    _, res = _dsync(hybrid4)
    for r in res:
        assert not r["full_on"]
        np.testing.assert_array_equal(r["bsp"], r["full"])


def test_dsync_sgd_local_group_every1_equals_bsp(hybrid4):
    """SGD linearity: local steps averaged every step are the BSP step up
    to f32 reassociation (tests/test_dsync.py's tolerances)."""
    _, res = _dsync(hybrid4)
    for r in res:
        np.testing.assert_allclose(r["bsp"], r["local"], rtol=2e-5,
                                   atol=2e-6)
        np.testing.assert_allclose(r["bsp_table"], r["local_table"],
                                   rtol=1e-4, atol=1e-6)


def test_dsync_local_sgd_every4_diverges_and_converges(hybrid4):
    _, res = _dsync(hybrid4)
    for r in res:
        assert np.abs(r["bsp24"] - r["k4"]).max() > 1e-6
        assert r["k4_eval"]["auc"] > 0.6, r["k4_eval"]
    np.testing.assert_array_equal(res[0]["k4"], res[-1]["k4"])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launcher_hybrid_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("HERALD_COMPILE_CACHE", "")
    from herald_tpu import HeraldConfig as JaxConfig
    from herald_tpu.launch.cli import build_parser as jax_parser
    from herald_tpu.launch.cli import run_training as jax_run
    from herald_tpu.train.engine import Engine as JaxEngine
    jcfg = JaxConfig(model="wdl_criteo", batch_size=16, embedding_dim=8,
                     comm_mode="hybrid", mesh_shape=(2,), seed=5)
    (tmp_path / "cfg.json").write_text(jcfg.to_json())
    jeng = JaxEngine(jcfg, table_rows=3000)
    leaves = _numpy_state(jeng.init_state(5))
    for r in range(2):
        torch.save(shard_state(leaves, jeng.exchange, r, "cpu")._asdict(),
                   tmp_path / f"init.r{r}.pt")
    run_ranks(launch_rank, 2, tmp_path, tmp_path, LAUNCH)
    jx = jax_run(jax_parser().parse_args(
        LAUNCH + ["--no-prefetch", "--config", str(tmp_path / "cfg.json")]))
    assert jx["devices"] == 2
    reports = [torch.load(tmp_path / f"report.r{r}.pt", weights_only=False)
               for r in range(2)]
    for port in reports:
        assert port["devices"] == 2 and port["backend"] == "gloo"
        assert port["comm"] == "hybrid"
        assert port["steps"] == jx["steps"] == 40
        assert port["overflow_rows"] == jx["overflow_rows"] == 0
        assert abs(port["train_loss_last"] - jx["train_loss_last"]) <= 1e-5
        assert abs(port["val_auc"] - jx["val_auc"]) <= 1e-4
        assert len(port["epochs"]) == len(jx["epochs"]) == 1
        for a, b in zip(port["epochs"], jx["epochs"]):
            assert abs(a["train_loss"] - b["train_loss"]) <= 1e-5
            assert abs(a["val_auc"] - b["val_auc"]) <= 1e-4
    assert reports[0]["val_auc"] == reports[1]["val_auc"]


def test_launcher_under_torch_distributed_run(tmp_path):
    """`python -m torch.distributed.run --standalone --nproc-per-node 2
    -m herald_tpu_torch.launch --comm hybrid --device cpu`: its
    environment makes the group, rank 0 alone prints the report and
    writes the logs."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "herald_tpu_torch.launch",
           *LAUNCH, "--comm", "hybrid", "--device", "cpu", "--max-steps",
           "6", "--log-dir", str(tmp_path / "logs")]
    p = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=180)
    assert p.returncode == 0, p.stderr[-3000:]
    report = json.loads(p.stdout[p.stdout.index("{\n"):])
    assert p.stdout.count('"model": "wdl_criteo"') == 1
    assert (report["devices"], report["backend"], report["steps"]) == \
        (2, "gloo", 6)
    assert report["stopped_early"] and report["overflow_rows"] == 0
    assert np.load(tmp_path / "logs" / "losses.npy").shape == (6,)
