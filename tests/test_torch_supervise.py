"""The port's restart supervisor (`python -m
herald_tpu_torch.launch.supervise`), as tests/test_supervise.py holds
herald_tpu's: a child that crashes (`--crash-after`) is relaunched from
its last checkpoint and ends on the uninterrupted run's model, and a
child that always fails is given up after `--max-restarts`."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CHILD = ["--model", "wdl_criteo", "--comm", "local", "--scheduled",
         "--batch-size", "16", "--samples", "1024", "--rows", "800",
         "--cache-limit-ratio", "0.6", "--lr", "0.5", "--nepoch", "1",
         "--scan-steps", "2", "--val-ratio", "0.25", "--seed", "3",
         "--device", "cpu"]


def _run(args, tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "-m", *args], cwd=tmp_path,
                          capture_output=True, text=True, env=env,
                          timeout=300)


def _last_report(out: str) -> dict:
    idx = out.rindex('"model"')
    return json.loads(out[out.rindex("{", 0, idx):])


def test_supervisor_recovers_crashed_run(tmp_path):
    ref = _run(["herald_tpu_torch.launch", *CHILD], tmp_path)
    assert ref.returncode == 0, ref.stdout[-2000:] + ref.stderr[-2000:]
    ref_rep = _last_report(ref.stdout)
    # checkpoints every 4 steps, a crash at step 6
    sup = _run(["herald_tpu_torch.launch.supervise", "--ckpt-dir",
                str(tmp_path / "ck"), "--ckpt-every", "4", "--backoff",
                "0.1", "--", *CHILD, "--crash-after", "6"], tmp_path)
    assert sup.returncode == 0, sup.stdout[-2000:] + sup.stderr[-2000:]
    assert '"crashed_at": 6' in sup.stdout
    assert "restarting from checkpoint" in sup.stderr
    assert sup.stderr.count("launch (attempt") == 2
    rep = _last_report(sup.stdout)
    assert not rep["stopped_early"]
    # the restart resumed at step 4 and trained the rest
    assert rep["steps"] == ref_rep["steps"] - 4
    assert rep["val_auc"] == ref_rep["val_auc"]
    assert rep["val_acc"] == ref_rep["val_acc"]


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    out = _run(["herald_tpu_torch.launch.supervise", "--ckpt-dir",
                str(tmp_path / "ck"), "--max-restarts", "2", "--backoff",
                "0.05", "--", "--model", "no_such_model", "--device",
                "cpu"], tmp_path)
    assert out.returncode != 0
    assert out.stderr.count("launch (attempt") == 3   # 1 + 2 restarts
    assert "giving up" in out.stderr
    assert not (tmp_path / "ck").exists()
