"""The launcher's input feed over 2 gloo ranks on the CPU (`--comm
hybrid`): one spawn of 2 ranks (`tests/_ranks.py`) runs
`cli.run_training` again and again in one process group:
- `--scheduled` with `--prestage 3` (the producer pops through
  `BroadcastPlanner` on the group of its own, `Comm.host_group`, while
  the steps' collectives use the training group) against `--prestage 0`;
- the plain branch with its prefetcher (each rank staging its block of
  every global batch, an epoch of 65 global steps that `--scan-steps 8`
  does not divide) against `--no-prefetch`;
each bit for bit: per-step losses, the reports and every rank's
checkpoint files; and `--preprocess-raw`, whose files rank 0 alone
writes before every rank loads them."""

import json

import numpy as np
import pytest
import torch

from _ranks import run_ranks
from herald_tpu_torch.launch import cli

COMMON = ["--model", "wdl_criteo", "--batch-size", "16",
          "--embedding-size", "8", "--rows", "3000", "--val-ratio", "0.2",
          "--scan-steps", "8", "--seed", "5", "--lr", "0.5"]
SCHED = ["--scheduled", "--nepoch", "2", "--samples", "1600",
         "--cache-limit-ratio", "0.3", "--pinned-rows", "64"]
PLAIN = ["--nepoch", "2", "--samples", "2600"]


TIMING = ("examples_per_sec", "examples_per_sec_steady",
          "examples_per_sec_steady_segments", "timing")


def _untimed(report):
    """A report without its clocks (the planner's included)."""
    out = {k: v for k, v in report.items() if k not in TIMING}
    if "cache" in out:
        out["cache"] = {k: v for k, v in out["cache"].items()
                        if k != "plan_time_us"}
    return out


def _same_checkpoint(a, b):
    """Two checkpoint directories hold the same files and the same bits."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert fa == sorted(p.relative_to(b) for p in b.rglob("*")
                        if p.is_file()) and fa
    for rel in fa:
        if rel.suffix == ".npz":
            with np.load(a / rel) as x, np.load(b / rel) as y:
                assert sorted(x.files) == sorted(y.files)
                for k in x.files:
                    assert x[k].dtype == y[k].dtype, (rel, k)
                    assert x[k].tobytes() == y[k].tobytes(), (rel, k)
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def _write_raw_criteo(path, n, seed):
    """A raw Criteo TSV: label, 13 integer and 26 hex categorical columns,
    some cells blank."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            f.write("\t".join(
                [str(rng.integers(0, 2))]
                + ["" if rng.random() < 0.2 else str(rng.integers(-1, 200))
                   for _ in range(13)]
                + ["" if rng.random() < 0.1
                   else f"{rng.integers(0, 12) * 7919:08x}"
                   for _ in range(26)]) + "\n")


def _feed_rank(rank, S, init, out, runs):
    """cli.run_training for each (name, argv) of `runs` over one group,
    each report to out/<name>.r<rank>.json; the calls of the port's
    criteo preprocessor on this rank to out/pp.r<rank>.json."""
    torch.set_num_threads(1)
    import herald_tpu_torch.data as data
    from herald_tpu_torch.parallel import comm
    comm.setup("cpu", init_method=init, rank=rank, world_size=S)
    calls = []
    real = data.preprocess_criteo
    data.preprocess_criteo = lambda *a, **k: calls.append(a) or real(*a, **k)
    for name, argv in runs:
        rep = cli.run_training(cli.build_parser().parse_args(
            COMMON + argv + ["--device", "cpu", "--comm", "hybrid",
                             "--log-dir", str(out / "logs" / name)]))
        (out / f"{name}.r{rank}.json").write_text(
            json.dumps(rep, default=float))
    (out / f"pp.r{rank}.json").write_text(json.dumps(len(calls)))


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    out = tmp_path_factory.mktemp("feed_hybrid")
    _write_raw_criteo(out / "train.txt", 800, 3)
    runs = [("sched-0", SCHED + ["--prestage", "0"]),
            ("sched-3", SCHED + ["--prestage", "3"]),
            ("plain-pf", PLAIN),
            ("plain-direct", PLAIN + ["--no-prefetch"]),
            ("preprocess", ["--nepoch", "1", "--preprocess-raw",
                            str(out / "train.txt"), "--data-path",
                            str(out / "data")])]
    runs = [(n, a + (["--ckpt", str(out / f"ck-{n}")] if n != "preprocess"
                     else [])) for n, a in runs]
    run_ranks(_feed_rank, 2, out, out, runs, timeout=240)
    reports = {name: [json.loads((out / f"{name}.r{r}.json").read_text())
                      for r in range(2)] for name, _ in runs}
    return out, reports


@pytest.mark.parametrize("fed,per_chunk", [("sched-3", "sched-0"),
                                           ("plain-pf", "plain-direct")],
                         ids=["prestage", "prefetch"])
def test_staged_ahead_is_the_per_chunk_run(launched, fed, per_chunk):
    out, reports = launched
    for r in range(2):
        a, b = reports[fed][r], reports[per_chunk][r]
        assert (a["devices"], a["backend"]) == (2, "gloo")
        assert _untimed(a) == _untimed(b)
    assert reports[fed][0]["val_auc"] == reports[fed][1]["val_auc"]
    steps = 160 // 2 if fed.startswith("sched") else 2 * (2080 // 32)
    assert reports[fed][0]["steps"] == steps
    x, y = (np.load(out / "logs" / n / "losses.npy") for n in (fed,
                                                              per_chunk))
    assert len(x) == steps and x.tobytes() == y.tobytes()
    _same_checkpoint(out / f"ck-{fed}", out / f"ck-{per_chunk}")
    assert {p.name for p in (out / f"ck-{fed}").rglob("shards.p*.npz")} \
        == {"shards.p0.npz", "shards.p1.npz"}


def test_preprocess_raw_writes_its_files_once(launched):
    out, reports = launched
    assert [json.loads((out / f"pp.r{r}.json").read_text())
            for r in range(2)] == [1, 0]
    assert len(list((out / "data").glob("*.npy"))) == 6
    rep = reports["preprocess"]
    assert rep[0]["steps"] == rep[1]["steps"] == (720 - 144) // 32
    assert rep[0]["val_auc"] == rep[1]["val_auc"]
