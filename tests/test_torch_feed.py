"""The launcher's input feed on the CPU (`herald_tpu_torch/launch/cli.py`):
the plain branch's `DevicePrefetcher`, the scheduled branch's
`_Prestager` and `--preprocess-raw`, against the port's own per-chunk
paths bit for bit and against herald_tpu.launch (wdl_criteo, 3,000 rows,
embedding 8, batch 16).

Runs compared with JAX start from one JAX checkpoint at step 0
(`--resume`), and are held within tests/test_torch_launch.py's
tolerances (`_close`: per-epoch and final 20-step mean loss 1e-5,
validation AUC 1e-4). The port's prefetched run is held to JAX's
`--no-prefetch` run: JAX's prefetcher trains `num_chunks * K` steps an
epoch (herald_tpu/data/prefetch.py:38-40, cli.py:1148-1157) and drops the
rest when `--scan-steps` does not divide the epoch (a reference fault,
ROADMAP queue 3), which `test_jax_prefetcher_drops_the_epochs_tail` pins.
"""

import json

import numpy as np
import pytest
import torch

from herald_tpu import HeraldConfig as JaxConfig
from herald_tpu.launch.cli import build_parser as jax_parser
from herald_tpu.launch.cli import run_training as jax_run
from herald_tpu.train.checkpoint import save_checkpoint as jax_save
from herald_tpu_torch.launch import cli
from herald_tpu_torch.train.cached import CachedEngine

ROWS = 3000
COMMON = ["--model", "wdl_criteo", "--batch-size", "16",
          "--embedding-size", "8", "--rows", str(ROWS), "--val-ratio",
          "0.2", "--scan-steps", "8", "--seed", "5", "--lr", "0.5"]
# 1,280 training samples: 80 steps an epoch, which K = 8 divides; 2,080:
# 130 steps, which it does not
SAMPLES = {"divides": "1600", "not_divides": "2600"}
SCHED = ["--scheduled", "--nepoch", "2", "--samples", "1600",
         "--cache-limit-ratio", "0.3", "--pinned-rows", "64"]
TIMING = ("examples_per_sec", "examples_per_sec_steady",
          "examples_per_sec_steady_segments", "timing")


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
    return jax_run(jax_parser().parse_args(COMMON + argv))


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


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """JAX's step-0 checkpoints: the plain state and the cached state."""
    out = tmp_path_factory.mktemp("feed_init")
    from herald_tpu.train.cached import CachedEngine as JaxCachedEngine
    from herald_tpu.train.engine import Engine as JaxEngine
    cfg = JaxConfig(model="wdl_criteo", batch_size=16, embedding_dim=8,
                    learning_rate=0.5, seed=5)
    jax_save(JaxEngine(cfg, table_rows=ROWS).init_state(5),
             str(out / "plain"))
    cfg = JaxConfig(model="wdl_criteo", batch_size=16, embedding_dim=8,
                    learning_rate=0.5, seed=5, use_cache=True,
                    use_scheduler=True, cache_limit_ratio=0.3,
                    pinned_rows=64)
    jax_save(JaxCachedEngine(cfg, table_rows=ROWS).init_cached_state(5),
             str(out / "cached"))
    return out


# ----------------------------------------------------------------------
# the plain branch's prefetcher
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(SAMPLES))
def test_prefetch_on_and_off_are_bit_identical(tmp_path, shape):
    runs = {}
    for name, extra in (("on", []), ("off", ["--no-prefetch"])):
        runs[name] = _port(["--samples", SAMPLES[shape], "--nepoch", "2",
                            "--ckpt", str(tmp_path / name), "--log-dir",
                            str(tmp_path / f"log-{name}")] + extra)
    steps = 2 * (int(SAMPLES[shape]) * 8 // 10 // 16)
    assert runs["on"]["steps"] == runs["off"]["steps"] == steps
    assert _untimed(runs["on"]) == _untimed(runs["off"])
    a, b = (np.load(tmp_path / f"log-{n}" / "losses.npy")
            for n in ("on", "off"))
    assert a.tobytes() == b.tobytes()
    _same_checkpoint(tmp_path / "on", tmp_path / "off")


def test_prefetched_run_matches_jaxs_direct_path(jax_init):
    argv = ["--samples", SAMPLES["not_divides"], "--nepoch", "2",
            "--resume", str(jax_init / "plain")]
    port = _port(argv)
    jx = _jax(argv + ["--no-prefetch"])
    assert port["steps"] == jx["steps"] == 260
    _close(port, jx)


def test_jax_prefetcher_drops_the_epochs_tail(jax_init):
    """The reference fault: with K = 8 over 130 steps an epoch JAX's
    prefetched run trains 128 an epoch, its direct path 130."""
    argv = ["--samples", SAMPLES["not_divides"], "--nepoch", "2",
            "--resume", str(jax_init / "plain")]
    prefetched = _jax(argv)
    assert prefetched["steps"] == 256 != _port(argv)["steps"] == 260


# ----------------------------------------------------------------------
# the scheduled branch's prestager
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def prestaged(tmp_path_factory, jax_init):
    """The port's scheduled runs at --prestage 0, 3 and all, from JAX's
    cached step-0 state: (out dir, {prestage: report})."""
    out = tmp_path_factory.mktemp("prestage")
    reports = {}
    for p in ("0", "3", "all"):
        reports[p] = _port(SCHED + ["--prestage", p, "--resume",
                                    str(jax_init / "cached"), "--ckpt",
                                    str(out / p), "--log-dir",
                                    str(out / f"log-{p}")])
    return out, reports


@pytest.mark.parametrize("prestage", ["3", "all"])
def test_prestage_depths_are_bit_identical(prestaged, prestage):
    out, reports = prestaged
    assert _untimed(reports[prestage]) == _untimed(reports["0"])
    assert reports[prestage]["steps"] == 160
    a, b = (np.load(out / f"log-{p}" / "losses.npy")
            for p in (prestage, "0"))
    assert a.tobytes() == b.tobytes()
    _same_checkpoint(out / prestage, out / "0")


@pytest.mark.parametrize("prestage", ["0", "3", "all"])
def test_prestaged_launcher_matches_jax(prestaged, jax_init, prestage):
    port = prestaged[1][prestage]
    jx = _jax(SCHED + ["--no-prefetch", "--prestage", prestage, "--resume",
                       str(jax_init / "cached")])
    assert set(port) == set(jx) | {"device", "noflush_chunks",
                                   "nopull_chunks"}
    _close(port, jx)
    pc, jc = dict(port["cache"]), dict(jx["cache"])
    pc.pop("plan_time_us"), jc.pop("plan_time_us")
    assert pc == jc and pc["miss_pull"] > 0


def test_prestaged_launcher_trace_holds_the_programs_spans(prestaged):
    """`--log-dir`'s trace.json of the run at --prestage 3 holds the
    consumer's waits for staged chunks and the dispatch of their steps,
    on one thread. The staging pool's `stage.*` spans land there only
    where the profiler records that pool's threads too (torch's CPU
    profiler records the thread that started it): any found lie on
    another thread than the consumer's."""
    out, _ = prestaged
    events = json.loads((out / "log-3" / "trace.json").read_text())
    spans = [e for e in events["traceEvents"] if e.get("ph") == "X"
             and str(e.get("name", "")).startswith("herald.")]
    threads = {e["name"]: {x["tid"] for x in spans
                           if x["name"] == e["name"]} for e in spans}
    consumer = threads["herald.launch.stage_wait"]
    assert consumer == threads["herald.step.dispatch"]
    staging = set().union(*(t for n, t in threads.items()
                            if n.startswith("herald.stage.")))
    assert not staging & consumer


def test_prestager_after_autosize_with_serve_view(tmp_path):
    """The prestager starts once the wide engine's cold steps are done,
    and the serve view's residency mirror advances at dispatch: every
    checkpoint (each --ckpt-every crossing and the last) and its overlay
    equal the per-chunk path's."""
    argv = SCHED + ["--autosize", "--autosize-warmup", "6",
                    "--device-data", "--ckpt-serve-view", "--ckpt-every",
                    "24"]
    runs = {p: _port(argv + ["--prestage", p, "--ckpt", str(tmp_path / p)])
            for p in ("0", "2")}
    assert _untimed(runs["2"]) == _untimed(runs["0"])
    _same_checkpoint(tmp_path / "2", tmp_path / "0")


def test_prestage_all_chosen_when_the_stream_fits(tmp_path, capsys,
                                                  monkeypatch):
    """--plan-cache with --device-data stages the whole stream when its
    estimate (the bytes of a staged step's packed row, times the steps)
    fits HERALD_PRESTAGE_BUDGET, and prints JAX's line."""
    argv = SCHED + ["--plan-cache", str(tmp_path / "tape"), "--device-data"]
    staged = []
    orig = CachedEngine._stage_chunk

    def spy(self, *a, **k):
        out = orig(self, *a, **k)
        staged.append(out.packed.shape)
        return out
    monkeypatch.setattr(CachedEngine, "_stage_chunk", spy)
    rep = _port(argv)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith('{"prestage"')]
    assert len(lines) == 1 and lines[0]["prestage"] == "all"
    assert lines[0]["est_bytes"] == 160 * staged[0][1]
    assert sum(s[0] for s in staged) == rep["steps"] == 160
    monkeypatch.setenv("HERALD_PRESTAGE_BUDGET", "0")
    again = _port(argv)
    assert '{"prestage"' not in capsys.readouterr().out
    assert _untimed(again) == _untimed(rep)
    assert again["cache"]["plan_time_us"] == 0


@pytest.mark.parametrize("where", ["pool", "producer"])
@pytest.mark.parametrize("prestage", ["0", "3"])
def test_a_staging_error_ends_the_run(monkeypatch, where, prestage):
    from herald_tpu_torch.sched.planner import CachePlanner
    cls, name = ((CachedEngine, "_stage_chunk") if where == "pool"
                 else (CachePlanner, "pop_chunk"))
    orig, calls = getattr(cls, name), []

    def failing(self, *a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError(f"{where} fails")
        return orig(self, *a, **k)
    monkeypatch.setattr(cls, name, failing)
    with pytest.raises(RuntimeError, match=f"{where} fails"):
        _port(SCHED + ["--prestage", prestage])


# ----------------------------------------------------------------------
# --preprocess-raw
# ----------------------------------------------------------------------

def write_raw_criteo(path, n, seed):
    """A raw Criteo TSV: label, 13 integer and 26 hex categorical columns,
    some cells blank."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, 2, n)
    ints = rng.integers(-1, 200, (n, 13))
    cats = rng.integers(0, 12, (n, 26))
    blank_i = rng.random((n, 13)) < 0.2
    blank_c = rng.random((n, 26)) < 0.1
    with open(path, "w") as f:
        for i in range(n):
            f.write("\t".join(
                [str(lab[i])]
                + ["" if blank_i[i, j] else str(ints[i, j])
                   for j in range(13)]
                + ["" if blank_c[i, j] else f"{cats[i, j] * 7919:08x}"
                   for j in range(26)]) + "\n")


def test_preprocess_raw_end_to_end_matches_jax(tmp_path, jax_init):
    write_raw_criteo(tmp_path / "train.txt", 800, 3)
    argv = ["--preprocess-raw", str(tmp_path / "train.txt"), "--nepoch",
            "2", "--resume", str(jax_init / "plain")]
    port = _port(argv + ["--data-path", str(tmp_path / "port")])
    jx = _jax(argv + ["--data-path", str(tmp_path / "jax"),
                      "--no-prefetch"])
    for name in ("train_dense_feats.npy", "train_sparse_feats.npy",
                 "train_labels.npy", "test_dense_feats.npy",
                 "test_sparse_feats.npy", "test_labels.npy"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    assert port["steps"] == 2 * (720 - 144) // 16
    _close(port, jx)


@pytest.mark.parametrize("argv,match", [
    (["--preprocess-raw", "train.txt"], "requires --data-path"),
    (["--preprocess-raw", "a.csv", "--data-path", "d", "--model",
      "wdl_adult"], "criteo, avazu or criteosearch"),
], ids=["no-data-path", "dataset"])
def test_preprocess_raw_refusals(argv, match):
    with pytest.raises(ValueError, match=match):
        _port(argv)
