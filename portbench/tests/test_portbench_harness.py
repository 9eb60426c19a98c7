"""The harness finds a cell's configuration, mix, driver, metrics and
limits by name, and a later cell comes in as new files and new entries
alone."""

import io
import json
import shutil
import time

from conftest import ROOT, TINY

from portbench import harness


def test_cell_files_found_by_name(bench):
    run = harness.Run(bench, "wdl_criteo.sched_churn", 1, 1, False,
                      device="cpu")
    assert run.cfg["name"] == "wdl_criteo"
    assert run.mix["driver"] == "sched"
    assert run.driver().Workload.__name__ == "Workload"
    assert run.reference().__name__.endswith("wdl")
    names = {m["name"] for m in run.metric_entries()}
    assert "stage_host_ms_per_step" in names
    assert "k2_scatter_roofline.train" not in names
    assert set(run.limits) >= {"loss_gap", "grad_gap", "change_gap",
                               "stage_held_gap", "stage_flush_gap"}


def test_every_entry_has_its_files(bench):
    base = ROOT / "portbench"
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (base / "reference" / f"{cfg['reference']}.py").exists()
    for w in bench["workloads"]:
        mix = json.loads((base / "mixes" / f"{w['traffic']}.json")
                         .read_text())
        assert (base / "drivers" / f"{mix['driver']}.py").exists()
        assert (base / "limits" / f"{w['name']}.json").exists()
    for m in bench["per_layer"]:
        assert any((base / "metrics" / f"{stem}.py").exists() for stem in
                   (m["name"], m["name"].split(".")[0])), m["name"]


def test_metric_reader_falls_back_to_its_stem(bench):
    run = harness.Run(bench, "wdl_criteo.plain_stream", 1, 1, False,
                      device="cpu")
    a = run.metric_reader("step_mfu.train")
    b = run.metric_reader("step_mfu.serve")
    assert a.__file__ == b.__file__
    assert a.__file__.endswith("step_mfu.py")
    assert run.metric_reader("cache_miss_rate").__file__.endswith(
        "cache_miss_rate.py")


def test_new_cell_needs_only_new_files(bench, tmp_path):
    """A configuration, a mix and a metric added as files beside copies
    of the existing ones, with entries added to BENCHMARK.json: the new
    cell runs and reports the new metric; no existing file changes."""
    base = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    cfg = json.loads((base / "configs" / "wdl_criteo.json").read_text())
    cfg.update(name="wdl_small", table_rows=40_000)
    (base / "configs" / "wdl_small.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "mixes" / "plain_stream.json").read_text())
    mix["zipf_a"] = 1.5
    (base / "mixes" / "plain_skewed.json").write_text(json.dumps(mix))
    (base / "metrics" / "examples_per_step.py").write_text(
        "def read(r):\n    return r.cfg['batch_size']\n")
    (base / "limits" / "wdl_small.plain_skewed.json").write_text(
        (base / "limits" / "wdl_criteo.plain_stream.json").read_text())
    bench = json.loads(json.dumps(bench))
    bench["configs"].append({"name": "wdl_small", "source": "x",
                             "file": "portbench/configs/wdl_small.json",
                             "reduced": ["table_rows"], "why": "x"})
    bench["workloads"].append({"name": "wdl_small.plain_skewed",
                               "config": "wdl_small",
                               "traffic": "plain_skewed", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "examples_per_step", "unit": "n",
                               "better": "higher", "source": "host_clock",
                               "layer": "Plain step",
                               "moves": "train_examples_per_s",
                               "workloads": ["wdl_small.plain_skewed"]})
    run = harness.Run(bench, "wdl_small.plain_skewed", 5, 0.3, True,
                      device="cpu", overrides={"config": {
                          k: v for k, v in TINY["config"].items()
                          if k != "table_rows"}, "mix": TINY["mix"]},
                      base=base)
    out, err = io.StringIO(), io.StringIO()
    res = harness.execute(run, time.perf_counter(), out=out, err=err)
    assert res["correct"], err.getvalue()
    assert res["metrics"]["examples_per_step"]["value"] == 32
    after = {p: p.read_bytes() for p in before}
    assert after == before
