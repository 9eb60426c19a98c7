"""Each driver end to end on the CPU at a tiny size, with the kernels'
plain versions: set-up, window, result line and the check."""

import io
import json
import time

import pytest
from conftest import SERVE_CELL, TINY

from portbench import harness

CELLS = ["wdl_criteo.sched_churn", "wdl_criteo.plain_stream", SERVE_CELL]


@pytest.fixture
def cell_bench(request, bench):
    """(bench, base) that hold the cell `request.param` names."""
    if request.param == SERVE_CELL:
        return request.getfixturevalue("serve_bench")
    return bench, harness.HERE


def run_cell(bench, name, seed, trace=False, overrides=TINY, seconds=0.5,
             base=harness.HERE):
    out, err = io.StringIO(), io.StringIO()
    run = harness.Run(bench, name, seed, seconds, trace, device="cpu",
                      overrides=overrides, base=base)
    harness.execute(run, time.perf_counter(), out=out, err=err)
    line = out.getvalue().strip().splitlines()[-1]
    return json.loads(line), err.getvalue()


@pytest.mark.parametrize("cell_bench,name", [(c, c) for c in CELLS],
                         indirect=["cell_bench"])
def test_cell_runs_and_is_correct(cell_bench, name):
    bench, base = cell_bench
    res, err = run_cell(bench, name, 2**31 + 11, base=base)
    assert res["correct"], err
    want = {m["name"] for m in bench["end_to_end"]
            if name in m.get("workloads", [name])}
    assert set(res["metrics"]) == want
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("cell_bench,name", [(c, c) for c in CELLS],
                         indirect=["cell_bench"])
def test_traced_run_reads_host_metrics(cell_bench, name):
    bench, base = cell_bench
    res, err = run_cell(bench, name, 7, trace=True, base=base)
    assert res["correct"], err
    host = {"wdl_criteo.sched_churn": {"planner_wait_ms_per_step",
                                       "cache_miss_rate",
                                       "stage_host_ms_per_step",
                                       "step_mfu.train"},
            "wdl_criteo.plain_stream": {"dispatch_host_ms_per_step",
                                        "step_mfu.train"},
            SERVE_CELL: {"step_mfu.serve"}}[name]
    assert host <= set(res["metrics"])
    names = {m["name"] for m in bench["per_layer"]}
    assert set(res["metrics"]) <= names
    # nothing ran on a device here: no roofline is read as 0
    assert not any(k.endswith(("roofline.train", "roofline.serve"))
                   for k in res["metrics"])
    assert "busy_s" in res["device"] and "breakdown" in res


def test_sched_stream_outgrows_its_cache(bench):
    res, err = run_cell(bench, "wdl_criteo.sched_churn", 3, trace=True)
    assert res["metrics"]["cache_miss_rate"]["value"] > 0
    line = next(x for x in err.splitlines() if x.startswith("stream:"))
    assert float(line.split(" x the cache")[0].split(", ")[-1]) > 1
    # the churned steps pull, read from their slots and flush, in the
    # stream's order
    read = dict(x[len("reading "):].split(": ") for x in err.splitlines()
                if x.startswith("reading stage_"))
    assert float(read["stage_steps_off_stream"]) == 0
    for k in ("stage_flushes", "stage_pulls", "stage_reads",
              "stage_flushed_only"):
        assert float(read[k]) > 0, (k, read)
