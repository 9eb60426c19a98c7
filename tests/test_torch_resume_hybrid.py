"""The launcher's checkpoints and resume over S ranks (`--comm hybrid`,
gloo ranks on the CPU), against its own uninterrupted runs and against
herald_tpu.launch on a 2-device mesh.

One spawn of 2 ranks (`_launches_rank`, `tests/_ranks.py`) runs
`cli.run_training` again and again in one process group:
- the plain, assign-only and scheduled branches (wdl_criteo, 3,000 rows,
  batch 16 a rank, one epoch of 40 global steps), each uninterrupted,
  stopped by `--max-steps 12` with `--ckpt` (and `--ckpt-every 8`), and
  resumed with `--resume`: the stopped and the resumed runs' per-step
  losses are the uninterrupted run's, bit for bit, and so are the final
  validation AUC and the last 20 steps' mean loss (tests/test_resume.py's
  invariant, over ranks);
- `--resume` of the checkpoint that herald_tpu.launch wrote on a 2-device
  mesh at step 12: within the tolerances of tests/test_torch_launch.py
  (mean losses 1e-5, AUC 1e-4) of JAX's own `--resume`;
- `--fae --ckpt`: trains and writes nothing, as in JAX.
Then, as the resize phases of tests/test_multihost4.py: the 2-rank plain
checkpoint resumed on one device by the port and by JAX (within the same
tolerances, finite); `--crash-after` over 2 processes of the launcher
(each given torch.distributed.run's environment) exits 17 on both; and
`--multihost` under two one-rank `torch.distributed.run` nodes on
127.0.0.1 gives the 2-rank `--standalone` run's losses bit for bit.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _ranks import run_ranks
from herald_tpu_torch.launch import cli

REPO = Path(__file__).resolve().parents[1]
COMMON = ["--model", "wdl_criteo", "--batch-size", "16",
          "--embedding-size", "8", "--samples", "1600", "--rows", "3000",
          "--val-ratio", "0.2", "--scan-steps", "4", "--seed", "5",
          "--lr", "0.5"]
MODES = {"plain": [], "assigned": ["--assign-only"],
         "scheduled": ["--scheduled", "--cache-limit-ratio", "0.3"]}
STOP, EPOCH = 12, 1280 // 32


@pytest.fixture(autouse=True)
def _no_jax_compile_cache(monkeypatch):
    # herald_tpu.launch turns on a persistent compile cache under /tmp
    monkeypatch.setenv("HERALD_COMPILE_CACHE", "")


def _launches_rank(rank, S, init, out, runs):
    """cli.run_training for each (name, argv) of `runs`, over one group;
    each run's report to out/<name>.r<rank>.json."""
    torch.set_num_threads(1)
    from herald_tpu_torch.parallel import comm
    comm.setup("cpu", init_method=init, rank=rank, world_size=S)
    for name, argv in runs:
        rep = cli.run_training(cli.build_parser().parse_args(
            argv + ["--device", "cpu", "--comm", "hybrid", "--log-dir",
                    str(out / "logs" / name)]))
        (out / f"{name}.r{rank}.json").write_text(
            json.dumps(rep, default=float))


def _jax(argv):
    from herald_tpu.launch.cli import build_parser as jax_parser
    from herald_tpu.launch.cli import run_training as jax_run
    return jax_run(jax_parser().parse_args(argv + ["--no-prefetch",
                                                   "--prestage", "0"]))


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """(out dir, {name: [each rank's report]}, JAX's resumed report)."""
    from herald_tpu import HeraldConfig as JaxConfig
    out = tmp_path_factory.mktemp("resume_hybrid")
    cfg = JaxConfig(model="wdl_criteo", batch_size=16, embedding_dim=8,
                    comm_mode="hybrid", mesh_shape=(2,), seed=5,
                    learning_rate=0.5)
    (out / "cfg.json").write_text(cfg.to_json())
    jcommon = COMMON + ["--config", str(out / "cfg.json"), "--comm",
                        "hybrid"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HERALD_COMPILE_CACHE", "")
        _jax(jcommon + ["--max-steps", str(STOP), "--ckpt",
                        str(out / "jax")])
        jax_rest = _jax(jcommon + ["--resume", str(out / "jax")])
    runs = []
    for mode, extra in MODES.items():
        base = COMMON + extra
        ck = str(out / f"ck-{mode}")
        runs += [(mode, base),
                 (f"{mode}-stop", base + ["--max-steps", str(STOP),
                                          "--ckpt-every", "8", "--ckpt", ck]),
                 (f"{mode}-rest", base + ["--resume", ck])]
    runs += [("jax-rest", COMMON + ["--config", str(out / "cfg.json"),
                                    "--resume", str(out / "jax")]),
             ("fae", COMMON + ["--model", "fae_wdl_criteo", "--ckpt",
                               str(out / "ck-fae")])]
    run_ranks(_launches_rank, 2, out, out, runs, timeout=300)
    reports = {name: [json.loads((out / f"{name}.r{r}.json").read_text())
                      for r in range(2)] for name, _ in runs}
    return out, reports, jax_rest


def _losses(out, name):
    return np.load(out / "logs" / name / "losses.npy")


@pytest.mark.parametrize("mode", list(MODES))
def test_stop_and_resume_is_the_uninterrupted_run(launched, mode):
    out, reports, _ = launched
    for r in range(2):
        whole, stop, rest = (reports[n][r] for n in
                             (mode, f"{mode}-stop", f"{mode}-rest"))
        assert (whole["devices"], whole["backend"]) == (2, "gloo")
        assert whole["steps"] == EPOCH and not whole["stopped_early"]
        assert stop["steps"] == STOP and stop["stopped_early"]
        assert rest["steps"] == EPOCH - STOP and not rest["stopped_early"]
        assert rest["val_auc"] == whole["val_auc"] is not None
        assert rest["train_loss_last"] == whole["train_loss_last"]
        assert rest["epochs"][-1]["val_auc"] == whole["epochs"][-1]["val_auc"]
    losses = _losses(out, mode)
    assert np.array_equal(_losses(out, f"{mode}-stop"), losses[:STOP])
    assert np.array_equal(_losses(out, f"{mode}-rest"), losses[STOP:])
    if mode == "scheduled":
        assert reports[mode][0]["cache"]["update_push"] > 0
    # the periodic save at step 8 and the final one at 12: two versions
    assert sorted(os.listdir(out / f"ck-{mode}")) == ["LATEST", "v12", "v8"]
    assert (out / f"ck-{mode}" / "LATEST").read_text() == "v12"
    assert sorted(f for f in os.listdir(out / f"ck-{mode}" / "v12")
                  if f.startswith("shards.")) == ["shards.p0.npz",
                                                  "shards.p1.npz"]


def test_resume_of_a_jax_two_device_launch(launched):
    _, reports, jx = launched
    assert jx["steps"] == EPOCH - STOP
    for port in reports["jax-rest"]:
        assert port["steps"] == jx["steps"]
        assert port["overflow_rows"] == jx["overflow_rows"] == 0
        assert abs(port["train_loss_last"] - jx["train_loss_last"]) <= 1e-5
        assert abs(port["val_auc"] - jx["val_auc"]) <= 1e-4
        for a, b in zip(port["epochs"], jx["epochs"]):
            assert abs(a["train_loss"] - b["train_loss"]) <= 1e-5
            assert abs(a["val_auc"] - b["val_auc"]) <= 1e-4


def test_fae_ignores_ckpt_over_two_ranks(launched):
    out, reports, _ = launched
    for rep in reports["fae"]:
        assert rep["mode"] == "fae" and rep["devices"] == 2
        assert rep["steps"] == EPOCH and np.isfinite(rep["train_loss_last"])
    assert not (out / "ck-fae").exists()


def test_two_rank_checkpoint_resumes_on_one_device(launched):
    """A resize: the 2-rank plain checkpoint at step 12, resumed on one
    device by the port (its table remapped) and by herald_tpu.launch: one
    device runs batches of 16, so 80 - 12 steps remain."""
    out, _, _ = launched
    argv = COMMON + ["--resume", str(out / "ck-plain")]
    port = cli.run_training(cli.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    jx = _jax(argv)
    assert port["devices"] == 1 and port["steps"] == jx["steps"] == 80 - STOP
    assert np.isfinite(port["train_loss_last"])
    assert abs(port["train_loss_last"] - jx["train_loss_last"]) <= 1e-5
    assert abs(port["val_auc"] - jx["val_auc"]) <= 1e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    return env


def test_crash_after_ends_every_rank_with_17(tmp_path):
    """Two processes of the launcher with the environment
    torch.distributed.run gives (whose agent would turn a rank's exit
    code into its own)."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "herald_tpu_torch.launch", *COMMON,
         "--scan-steps", "2", "--comm", "hybrid", "--device", "cpu",
         "--ckpt", str(tmp_path / "ck"), "--ckpt-every", "4",
         "--crash-after", "6"],
        env={**_env(), "RANK": str(r), "LOCAL_RANK": str(r),
             "WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2",
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port},
        cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [17, 17], outs
    assert '{"crashed_at": 6}' in outs[0][0]
    assert "crashed_at" not in outs[1][0]
    assert (tmp_path / "ck" / "LATEST").read_text() == "v4"


def test_multihost_nodes_match_the_standalone_run(tmp_path):
    run = [sys.executable, "-m", "torch.distributed.run"]
    launch = ["-m", "herald_tpu_torch.launch", *COMMON, "--comm", "hybrid",
              "--device", "cpu", "--max-steps", "6"]
    port = str(_free_port())
    procs = {f"node{i}": subprocess.Popen(
        run + ["--nnodes", "2", "--node-rank", str(i), "--nproc-per-node",
               "1", "--master-addr", "127.0.0.1", "--master-port", port]
        + launch + ["--multihost", "--log-dir", str(tmp_path / "multi")],
        env=_env(), cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(2)}
    procs["standalone"] = subprocess.Popen(
        run + ["--standalone", "--nproc-per-node", "2"] + launch
        + ["--log-dir", str(tmp_path / "one")], env=_env(), cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    outs = {}
    try:
        for k, p in procs.items():
            outs[k] = p.communicate(timeout=180)
    finally:
        for p in procs.values():
            p.kill()
    for k, p in procs.items():
        assert p.returncode == 0, (k, outs[k][1][-3000:])
    multi = json.loads(outs["node0"][0][outs["node0"][0].index("{\n"):])
    one = json.loads(outs["standalone"][0][
        outs["standalone"][0].index("{\n"):])
    assert "{\n" not in outs["node1"][0]     # rank 0 alone reports
    assert (multi["devices"], multi["backend"], multi["steps"]) == \
        (2, "gloo", 6)
    assert multi["val_auc"] == one["val_auc"]
    assert np.array_equal(np.load(tmp_path / "multi" / "losses.npy"),
                          np.load(tmp_path / "one" / "losses.npy"))


def test_multihost_without_torch_distributed_run_raises(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torch.distributed.run"):
        cli.run_training(cli.build_parser().parse_args(
            COMMON + ["--device", "cpu", "--comm", "hybrid",
                      "--multihost"]))
