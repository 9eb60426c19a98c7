"""The port's entry script and examples on the CPU, each a process of its
own: `herald_tpu_torch/bin/heraldrun` (plain and `--supervise`),
`herald_tpu_torch/examples/run_baseline.py`, `run_scheduled.py`,
`run_fae.py` and `ab.sh` (its four modes under `torch.distributed.run`
with one rank) give the report of `python -m herald_tpu_torch.launch`
with the same flags (wdl_criteo and fae_wdl_criteo at 3,000 rows,
embedding 8, batch 16, one epoch), bit for bit but for the clocks.
tests/test_torch_isolation.py scans the examples' imports with the rest
of the package."""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "herald_tpu_torch"
# ab.sh's flags, then the small run's (the later value of a flag wins)
BASE = ["--comm", "hybrid", "--nepoch", "1", "--batch-size", "256",
        "--embedding-size", "128", "--cache-limit-ratio", "0.1"]
SMALL = ["--batch-size", "16", "--embedding-size", "8", "--samples",
         "1600", "--rows", "3000", "--val-ratio", "0.2", "--scan-steps",
         "8", "--seed", "5", "--lr", "0.5", "--cache-limit-ratio", "0.3",
         "--device", "cpu"]
WDL = ["--model", "wdl_criteo"] + BASE + SMALL
FAE = ["--model", "fae_wdl_criteo", "--fae"] + BASE + SMALL
MODES = {"baseline": WDL, "assigned": ["--assign-only"] + WDL,
         "scheduled": ["--scheduled"] + WDL, "fae": FAE}
CLOCKS = ("examples_per_sec", "examples_per_sec_steady",
          "examples_per_sec_steady_segments", "timing", "backend")


def _report(out: str) -> dict:
    idx = out.rindex('"model"')
    rep = json.loads(out[out.rindex("{", 0, idx):])
    rep = {k: v for k, v in rep.items() if k not in CLOCKS}
    if "cache" in rep:
        rep["cache"] = {k: v for k, v in rep["cache"].items()
                        if k != "plan_time_us"}
    if "sched" in rep:
        rep["sched"] = {k: v for k, v in rep["sched"].items()
                        if k != "plan_time_us"}
    return rep


def _run(cmd, cwd, env=None):
    env = {**os.environ, "OMP_NUM_THREADS": "1", **(env or {})}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """Every command at once (four at a time): {name: process}."""
    tmp = tmp_path_factory.mktemp("heraldrun")
    path = {"PYTHONPATH": str(REPO)}
    heraldrun = [str(PKG / "bin" / "heraldrun")]
    ex = [sys.executable, "-u"]
    jobs = {f"launch:{m}": ([sys.executable, "-m", "herald_tpu_torch.launch",
                             *argv], path) for m, argv in MODES.items()}
    jobs.update({
        "heraldrun": (heraldrun + WDL, None),
        "heraldrun:supervise": (heraldrun + [
            "--supervise", "--ckpt-dir", str(tmp / "ck"), "--ckpt-every",
            "1000", "--"] + WDL, None),
        "example:baseline": (ex + [str(PKG / "examples" / "run_baseline.py")]
                             + WDL, None),
        "example:scheduled": (ex + [str(PKG / "examples" /
                                        "run_scheduled.py")] + WDL, None),
        "example:fae": (ex + [str(PKG / "examples" / "run_fae.py"),
                              "--model", "fae_wdl_criteo"] + BASE + SMALL,
                        None),
        "ab": (["bash", str(PKG / "examples" / "ab.sh")] + SMALL,
               {"NPROC": "1"}),
    })
    with ThreadPoolExecutor(4) as pool:
        futs = {name: pool.submit(_run, cmd, tmp, env)
                for name, (cmd, env) in jobs.items()}
        return tmp, {name: f.result() for name, f in futs.items()}


@pytest.mark.parametrize("name,mode", [
    ("heraldrun", "baseline"), ("heraldrun:supervise", "baseline"),
    ("example:baseline", "baseline"), ("example:scheduled", "scheduled"),
    ("example:fae", "fae")])
def test_entry_gives_the_launchers_report(ran, name, mode):
    _, procs = ran
    want = _report(procs[f"launch:{mode}"].stdout)
    assert want["mode"] == mode and want["steps"] > 0
    assert _report(procs[name].stdout) == want
    if name == "heraldrun:supervise":
        assert "[supervise] launch (attempt 1)" in procs[name].stderr


@pytest.mark.parametrize("mode", list(MODES))
def test_ab_ladder_mode_gives_the_launchers_report(ran, mode):
    tmp, procs = ran
    log = (tmp / f"ab_{mode}.log").read_text()
    assert log.startswith("== ")
    assert _report(log) == _report(procs[f"launch:{mode}"].stdout)
