"""The port's launcher (`python -m herald_tpu_torch.launch`) against
herald_tpu's on small synthetic runs (wdl_criteo, 3,000 rows, embedding 8,
batch 16), on the CPU.

The two packages draw their initial weights from different generators, so
the runs compared with JAX start from one JAX checkpoint at step 0
(`--resume`), f32 tables. Tolerances: the launcher runs the same steps on
the same batches, so per-epoch mean loss and the final 20-step mean agree
within 1e-5 and validation AUC within 1e-4 (the f32 towers sum in another
order: a probability that moves by 1e-7 can reorder a near-tie, and one
reordered pair moves the AUC by 1/(positives * negatives)).
A port run resumed from its own checkpoint is bit-exact against the
uninterrupted run: on the CPU, and through K3's fixed summation order on
the card (chip_smoke.py checks that).

The scheduled branch (`--scheduled`, the port at its default
`--prestage 3`) is held to the JAX launcher's with `--prestage 0` from one
JAX `CachedTrainState` checkpoint at step 0, with the same tolerances; its
planner counters are host integers and equal.
"""

import json

import jax
import numpy as np
import pytest
import torch

from _ranks import launch_rank, run_ranks
from herald_tpu import HeraldConfig as JaxConfig
from herald_tpu.launch.cli import build_parser as jax_parser
from herald_tpu.launch.cli import run_training as jax_run
from herald_tpu.train.checkpoint import save_checkpoint as jax_save
from herald_tpu.train.engine import Engine as JaxEngine
from herald_tpu.train.fae import FaeEngine as JaxFaeEngine
from herald_tpu.utils.profiler import StepTimer as JaxStepTimer
from herald_tpu_torch.bridge import shard_state
from herald_tpu_torch.launch import cli
from herald_tpu_torch.models import get_model
from herald_tpu_torch.train.checkpoint import load_checkpoint
from herald_tpu_torch.utils.profiler import StepTimer

ROWS = 3000
COMMON = ["--model", "wdl_criteo", "--batch-size", "16",
          "--embedding-size", "8", "--samples", "1600", "--rows", str(ROWS),
          "--val-ratio", "0.2", "--scan-steps", "8", "--seed", "5"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # the launches are small: one intra-op thread each, so that the other
    # workers of a parallel test run do not starve them (8 threads a
    # launch under 5 busy processes: 60-70 s a launch instead of 1 s)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_jax_compile_cache(monkeypatch):
    # herald_tpu.launch turns on a persistent compile cache under /tmp
    monkeypatch.setenv("HERALD_COMPILE_CACHE", "")


def _port(argv):
    return cli.run_training(cli.build_parser().parse_args(
        COMMON + ["--device", "cpu"] + argv))


def _jax(argv):
    return jax_run(jax_parser().parse_args(COMMON + ["--no-prefetch"]
                                           + argv))


def _jax_init_ckpt(path, opt, lr):
    cfg = JaxConfig(model="wdl_criteo", batch_size=16, embedding_dim=8,
                    optimizer=opt, learning_rate=lr, seed=5)
    eng = JaxEngine(cfg, table_rows=ROWS)
    jax_save(eng.init_state(5), path)


def _close(port, jx):
    assert port["steps"] == jx["steps"]
    assert port["stopped_early"] == jx["stopped_early"]
    assert port["overflow_rows"] == jx["overflow_rows"] == 0
    assert abs(port["train_loss_last"] - jx["train_loss_last"]) <= 1e-5
    assert abs(port["val_auc"] - jx["val_auc"]) <= 1e-4
    assert len(port["epochs"]) == len(jx["epochs"])
    for a, b in zip(port["epochs"], jx["epochs"]):
        assert a["epoch"] == b["epoch"]
        assert abs(a["train_loss"] - b["train_loss"]) <= 1e-5
        assert abs(a["val_auc"] - b["val_auc"]) <= 1e-4


def test_launcher_matches_jax_from_one_checkpoint(tmp_path):
    _jax_init_ckpt(str(tmp_path / "init"), "sgd", 0.5)
    argv = ["--lr", "0.5", "--nepoch", "1", "--resume",
            str(tmp_path / "init")]
    port, jx = _port(argv), _jax(argv)
    assert port["steps"] == 1280 // 16 and len(port["epochs"]) == 1
    assert set(port) == set(jx) | {"device"} and port["device"] == "cpu"
    assert port["mode"] == jx["mode"] == "baseline"
    _close(port, jx)


def test_jax_adam_checkpoint_resumed_by_the_port(tmp_path):
    """A JAX run checkpointed mid-epoch, then finished by each package."""
    _jax_init_ckpt(str(tmp_path / "init"), "adam", 0.01)
    common = ["--opt", "adam", "--lr", "0.01", "--nepoch", "1"]
    _jax(common + ["--resume", str(tmp_path / "init"), "--max-steps", "40",
                   "--ckpt", str(tmp_path / "mid")])
    resumed = common + ["--resume", str(tmp_path / "mid")]
    port = _port(resumed + ["--ckpt", str(tmp_path / "port")])
    jx = _jax(resumed + ["--ckpt", str(tmp_path / "jax")])
    assert port["steps"] == jx["steps"] == 80 - 40
    _close(port, jx)
    a = load_checkpoint(str(tmp_path / "port"), "cpu")
    b = load_checkpoint(str(tmp_path / "jax"), "cpu")
    assert int(a.step) == int(b.step) == 80
    assert set(a.table_slots) == set(b.table_slots) == {"m", "v"}
    np.testing.assert_allclose(a.table.numpy(), b.table.numpy(), rtol=0,
                               atol=1e-5)
    for k in b.dense:
        np.testing.assert_allclose(a.dense[k].numpy(), b.dense[k].numpy(),
                                   rtol=0, atol=1e-5)


def test_resume_across_a_checkpoint_is_bit_exact(tmp_path):
    _resume_is_bit_exact(tmp_path, "wdl_criteo")


def test_dfm_trains_and_resumes_bit_exact(tmp_path):
    """DeepFM through the launcher: its fused [rows, 9] table and the FM
    term (K5's plain versions on the CPU)."""
    a = _resume_is_bit_exact(tmp_path, "dfm_criteo")
    assert a.table.shape == (ROWS, 9)
    assert set(a.dense) == {"W1", "W2", "W3", "FM_W"}


def _resume_is_bit_exact(tmp_path, model):
    common = ["--model", model, "--bf16-table", "--lr", "0.5", "--nepoch",
              "2", "--scan-steps", "4"]
    whole = _port(common + ["--ckpt", str(tmp_path / "whole")])
    assert whole["model"] == model and np.isfinite(whole["train_loss_last"])
    first = _port(common + ["--ckpt", str(tmp_path / "part"),
                            "--ckpt-every", "30", "--max-steps", "100"])
    assert first["steps"] == 100 and first["stopped_early"]
    rest = _port(common + ["--resume", str(tmp_path / "part"),
                           "--ckpt", str(tmp_path / "rest")])
    assert rest["steps"] == whole["steps"] - 100
    assert rest["val_auc"] == whole["val_auc"]
    a = load_checkpoint(str(tmp_path / "whole"), "cpu")
    b = load_checkpoint(str(tmp_path / "rest"), "cpu")
    assert int(a.step) == int(b.step) == whole["steps"]
    assert a.table.dtype == torch.bfloat16
    assert torch.equal(a.table, b.table)
    assert all(torch.equal(a.dense[k], b.dense[k]) for k in a.dense)
    assert a.dense_slots == b.dense_slots == {k: {} for k in a.dense}
    return a


def test_log_dir_writes_report_losses_and_trace(tmp_path):
    out = tmp_path / "logs"
    rep = _port(["--nepoch", "1", "--max-steps", "6", "--log-dir",
                 str(out), "--save-config", str(tmp_path / "cfg.json")])
    assert json.loads((out / "report.json").read_text())["steps"] == 6
    assert np.load(out / "losses.npy").shape == (6,)
    assert (out / "trace.json").stat().st_size > 0
    assert rep["steps"] == 6
    cfg = json.loads((tmp_path / "cfg.json").read_text())
    assert cfg["model"] == "wdl_criteo" and "device" not in cfg


@pytest.mark.parametrize("argv,match", [
    (["--platform", "cpu"], "--platform"),
], ids=lambda v: v[0] if isinstance(v, list) else None)
def test_flags_not_ported_raise(argv, match):
    with pytest.raises(NotImplementedError, match=match) as e:
        _port(argv)
    assert "ROADMAP" in str(e.value)


@pytest.mark.parametrize("argv,match", [
    (["--plan-cache", "tape"], "--plan-cache is single-process only"),
    (["--ckpt-serve-view"], "--ckpt-serve-view is single-process only"),
], ids=lambda v: v[0])
def test_multi_rank_scheduled_one_process_options_raise(argv, match,
                                                        monkeypatch):
    """herald_tpu.launch's one-process options of the scheduled branch
    raise over S > 1 ranks with its messages, before any group is made."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match=match):
        _port(["--comm", "hybrid", "--scheduled"] + argv)


@pytest.mark.parametrize("argv", [["--fae"], ["--model", "fae_wdl_criteo"],
                                  ["--assign-only", "--lr", "0.5"]],
                         ids=lambda v: v[-1] if len(v) < 3 else v[0])
def test_multi_rank_modes_match_jax(argv, tmp_path, monkeypatch):
    """`--fae`, a fae_* model and `--assign-only` over 2 gloo ranks of
    the port (`_ranks.launch_rank`) against herald_tpu.launch on a
    2-device mesh, from JAX's initial state: the same global batches,
    and the same assignments for S = 2 workers in assign-only mode
    (the port's rank 0 plans and broadcasts them)."""
    jcfg = JaxConfig(model="wdl_criteo", batch_size=16, embedding_dim=8,
                     comm_mode="hybrid", mesh_shape=(2,), seed=5)
    (tmp_path / "cfg.json").write_text(jcfg.to_json())
    fae = "--assign-only" not in argv
    cls, name = (JaxFaeEngine, "init_fae_state") if fae else \
        (JaxEngine, "init_state")
    orig, captured = getattr(cls, name), {}

    def init(self, seed=None):
        st = orig(self, seed)
        captured["spec"] = self.exchange
        captured["state"] = jax.tree.map(np.asarray, st)
        return st
    monkeypatch.setattr(cls, name, init)
    jx = _jax(argv + ["--config", str(tmp_path / "cfg.json")])
    for r in range(2):
        torch.save(shard_state(captured["state"], captured["spec"], r,
                               "cpu")._asdict(), tmp_path / f"init.r{r}.pt")
    run_ranks(launch_rank, 2, tmp_path, tmp_path, COMMON + argv)
    reports = [torch.load(tmp_path / f"report.r{r}.pt", weights_only=False)
               for r in range(2)]
    for port in reports:
        assert set(port) == set(jx) | {"device", "backend"}
        assert (port["devices"], port["backend"]) == (2, "gloo")
        assert port["mode"] == jx["mode"] == ("fae" if fae else "assigned")
        assert port["steps"] == jx["steps"] == 1280 // 32
        assert abs(port["train_loss_last"] - jx["train_loss_last"]) <= 1e-5
        assert abs(port["val_auc"] - jx["val_auc"]) <= 1e-4
        assert len(port["epochs"]) == len(jx["epochs"]) == 1
        for a, b in zip(port["epochs"], jx["epochs"]):
            assert abs(a["train_loss"] - b["train_loss"]) <= 1e-5
            assert abs(a["val_auc"] - b["val_auc"]) <= 1e-4
        if fae:
            assert port["num_hot"] == jx["num_hot"] == 30
        else:
            assert port["overflow_rows"] == jx["overflow_rows"] == 0
            assert {k: v for k, v in port["sched"].items()
                    if k != "plan_time_us"} == {
                k: v for k, v in jx["sched"].items() if k != "plan_time_us"}
    assert reports[0]["val_auc"] == reports[1]["val_auc"]


def test_mp_shards_trains_checkpoints_and_resumes_like_jax(tmp_path,
                                                          monkeypatch):
    """`--comm hybrid --mp-shards 2` over 2 gloo ranks of the port ((dp,
    mp) = (1, 2), `_ranks.launch_rank`) against herald_tpu.launch on a
    (1, 2) mesh from JAX's initial state (its tower cut into the ranks'
    shards), within the tolerances above; a run stopped at step 16 and
    resumed from its checkpoint ends on the whole run's checkpoint, bit
    for bit."""
    jcfg = JaxConfig(model="wdl_criteo", batch_size=16, embedding_dim=8,
                     comm_mode="hybrid", mesh_shape=(1, 2), mp_shards=2,
                     learning_rate=0.5, seed=5)
    (tmp_path / "cfg.json").write_text(jcfg.to_json())
    orig, captured = JaxEngine.init_state, {}

    def init(self, seed=None):
        st = orig(self, seed)
        captured["spec"] = self.exchange
        captured["state"] = jax.tree.map(np.asarray, st)
        return st
    monkeypatch.setattr(JaxEngine, "init_state", init)
    base = ["--config", str(tmp_path / "cfg.json"), "--nepoch", "1"]
    jx = _jax(base)
    plan = get_model("wdl_criteo").tp_plan
    inits = [shard_state(captured["state"], captured["spec"], r, "cpu",
                         plan, 2)._asdict() for r in range(2)]

    def launch(name, argv):
        out = tmp_path / name
        out.mkdir()
        for r in range(2):
            torch.save(inits[r], out / f"init.r{r}.pt")
        run_ranks(launch_rank, 2, out, out, COMMON + base + argv)
        return [torch.load(out / f"report.r{r}.pt", weights_only=False)
                for r in range(2)]

    for port in launch("whole", ["--ckpt", str(tmp_path / "c_whole")]):
        assert (port["devices"], port["backend"]) == (2, "gloo")
        assert port["steps"] == jx["steps"] == 1280 // 32
        _close(port, jx)
    first = launch("first", ["--max-steps", "16",
                             "--ckpt", str(tmp_path / "c_part")])
    assert first[0]["steps"] == 16 and first[0]["stopped_early"]
    rest = launch("rest", ["--resume", str(tmp_path / "c_part"),
                           "--ckpt", str(tmp_path / "c_rest")])
    assert rest[0]["steps"] == 40 - 16
    a = load_checkpoint(str(tmp_path / "c_whole"), "cpu")
    b = load_checkpoint(str(tmp_path / "c_rest"), "cpu")
    assert int(a.step) == int(b.step) == 40
    assert torch.equal(a.table, b.table)
    assert all(torch.equal(a.dense[k], b.dense[k]) for k in a.dense)
    assert a.dense["W1"].shape == (13, 256)     # whole, joined from blocks


@pytest.mark.parametrize("argv,match", [
    (["--scheduled"], "dp-only"), (["--opt", "lamb"], "lamb"),
    (["--dense-sync-every", "2"], "dp-only"), (["--fae"], "FAE engine")],
    ids=lambda v: v[-1] if isinstance(v, list) else None)
def test_mp_shards_refusals(argv, match):
    """JAX's config refusals of --mp-shards (the scheduled branch, lamb,
    dense-sync), and the port's of the FAE engine, before any training."""
    with pytest.raises(ValueError, match=match):
        _port(["--comm", "hybrid", "--mp-shards", "2"] + argv)


def test_serve_view_flag_raises_as_in_jax():
    # outside --scheduled only: the scheduled branch writes the overlay
    with pytest.raises(ValueError, match="--ckpt-serve-view"):
        _port(["--ckpt-serve-view"])


def test_resume_refuses_a_checkpoint_of_another_optimizer(tmp_path):
    _port(["--nepoch", "1", "--max-steps", "2", "--ckpt",
           str(tmp_path / "sgd")])
    with pytest.raises(ValueError, match="optimizer slots"):
        _port(["--opt", "adam", "--resume", str(tmp_path / "sgd")])


def test_main_prints_the_report(capsys):
    assert cli.main(COMMON + ["--device", "cpu", "--nepoch", "1",
                              "--max-steps", "3"]) == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{\n"):])
    assert report["steps"] == 3 and report["stopped_early"]


def test_step_timer_reports_like_jax():
    mine, theirs = StepTimer(warmup=2), JaxStepTimer(warmup=2)
    assert mine.report() == theirs.report() == {"steps": 0}
    for _ in range(5):
        with mine:
            pass
        with theirs:
            pass
    a, b = mine.report(), theirs.report()
    assert a.keys() == b.keys() and a["steps"] == b["steps"] == 3
    assert 0 <= a["min_ms"] <= a["p50_ms"] <= a["max_ms"]


# ----------------------------------------------------------------------
# the scheduled branch
# ----------------------------------------------------------------------

SCHED = ["--scheduled", "--lr", "0.5", "--nepoch", "2",
         "--cache-limit-ratio", "0.3"]


def _jax_init_cached_ckpt(path, pinned=0):
    from herald_tpu.train.cached import CachedEngine as JaxCachedEngine
    cfg = JaxConfig(model="wdl_criteo", batch_size=16, embedding_dim=8,
                    learning_rate=0.5, seed=5, use_cache=True,
                    use_scheduler=True, cache_limit_ratio=0.3,
                    pinned_rows=pinned)
    jax_save(JaxCachedEngine(cfg, table_rows=ROWS).init_cached_state(5),
             path)


@pytest.mark.parametrize("pinned", [0, 64])
def test_scheduled_launcher_matches_jax_from_one_checkpoint(tmp_path,
                                                            pinned):
    _jax_init_cached_ckpt(str(tmp_path / "init"), pinned)
    argv = SCHED + ["--pinned-rows", str(pinned), "--resume",
                    str(tmp_path / "init")]
    port = _port(argv)
    jx = _jax(argv + ["--prestage", "0"])
    assert port["mode"] == jx["mode"] == "scheduled"
    assert port["steps"] == 2 * (1280 // 16)
    assert set(port) == set(jx) | {"device", "noflush_chunks",
                                   "nopull_chunks"}
    _close(port, jx)
    # the first epoch's eval is approximate (unsynced cache), the last one
    # runs after sync_cache, in both
    assert [e.get("val_approx_unsynced_cache") for e in port["epochs"]] \
        == [e.get("val_approx_unsynced_cache") for e in jx["epochs"]] \
        == [True, None]
    pc, jc = dict(port["cache"]), dict(jx["cache"])
    pc.pop("plan_time_us"), jc.pop("plan_time_us")
    assert pc == jc and pc["miss_pull"] > 0
    assert port["chunk_memo_hits"] == jx["chunk_memo_hits"]
    assert port["chunk_memo_active"] is jx["chunk_memo_active"]
    assert port["examples_per_sec_steady"] > 0


def test_scheduled_resume_across_a_midstream_checkpoint_is_bit_exact(
        tmp_path):
    from herald_tpu_torch.train.checkpoint import (load_cached_checkpoint,
                                                   load_extra)
    common = SCHED + ["--bf16-table", "--scan-steps", "4",
                      "--pinned-rows", "32", "--ckpt-serve-view"]
    whole = _port(common + ["--ckpt", str(tmp_path / "whole")])
    first = _port(common + ["--ckpt", str(tmp_path / "part"),
                            "--ckpt-every", "24", "--max-steps", "100"])
    assert first["steps"] == 100 and first["stopped_early"]
    assert first["val_auc"] is None          # unsynced: no final eval
    mid = load_cached_checkpoint(str(tmp_path / "part"), "cpu")
    assert int(mid.step) == 100
    assert load_extra(str(tmp_path / "part"), "serve_overlay") is not None
    rest = _port(common + ["--resume", str(tmp_path / "part"),
                           "--ckpt", str(tmp_path / "rest")])
    assert rest["steps"] == whole["steps"] - 100
    assert rest["val_auc"] == whole["val_auc"]
    a = load_cached_checkpoint(str(tmp_path / "whole"), "cpu")
    b = load_cached_checkpoint(str(tmp_path / "rest"), "cpu")
    assert int(a.step) == int(b.step) == whole["steps"]
    assert a.table.dtype == torch.bfloat16
    for x, y in ((a.table, b.table), (a.cache, b.cache),
                 (a.hot_table, b.hot_table)):
        assert torch.equal(x, y)
    assert all(torch.equal(a.dense[k], b.dense[k]) for k in a.dense)
    # the synced table holds the trained hot block
    assert torch.equal(a.table[:32], a.hot_table)


def test_scheduled_max_steps_on_an_epoch_boundary_keeps_its_eval():
    """The JAX launcher drops that epoch's eval (cli.py:993); the port
    records it, approximate since the cache is not synced."""
    rep = _port(SCHED + ["--max-steps", "80"])
    assert rep["steps"] == 80 and rep["stopped_early"]
    assert [e["epoch"] for e in rep["epochs"]] == [0]
    assert rep["epochs"][0]["val_approx_unsynced_cache"]


@pytest.mark.parametrize("extra", [
    ["--pinned-rows", "64"],
    ["--plan-cache", "TAPE"],
    ["--autosize", "--autosize-flush-budget", "--device-data"],
], ids=["pinned", "plan-cache", "autosize"])
def test_scheduled_options_run(tmp_path, extra):
    extra = [str(tmp_path / "tape") if a == "TAPE" else a for a in extra]
    rep = _port(SCHED + extra)
    assert rep["steps"] == 160 and rep["overflow_rows"] == 0
    assert rep["val_auc"] is not None and np.isfinite(rep["train_loss_last"])
    if "--plan-cache" in extra:
        again = _port(SCHED + extra)       # replays the recorded tape
        assert again["cache"]["plan_time_us"] == 0
        assert again["train_loss_last"] == rep["train_loss_last"]
        assert again["val_auc"] == rep["val_auc"]
    if "--autosize" in extra:
        plain = _port(SCHED)
        # exact sizing does not change the math, only the program widths
        assert rep["train_loss_last"] == plain["train_loss_last"]
        assert rep["val_auc"] == plain["val_auc"]
