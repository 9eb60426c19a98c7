"""The check fails what it must: the reference computed in TF32 or with
a bf16 tower in the program's place, at every width of the cells on a
small table; and a run of the harness with the timed path broken
underneath (a step that leaves its state unchanged, half of the batch
left out, a planner that drops a pull or swaps two flushes' slots, a
served score altered)."""

import io
import json
import time

import pytest
from conftest import FULL_WIDTH, ROOT, SERVE_CELL, TINY

from portbench import control, faults, harness


def limits(name, base=ROOT / "portbench"):
    return json.loads((base / "limits" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["wdl_criteo.plain_stream",
                                  "wdl_criteo.sched_churn", SERVE_CELL])
def test_controls_fail_the_limits(request, name):
    bench, base = None, ROOT / "portbench"
    if name == SERVE_CELL:
        bench, base = request.getfixturevalue("serve_bench")
    out = io.StringIO()
    rows = control.main(["--workload", name, "--seeds", "21"],
                        device="cpu", overrides=FULL_WIDTH, out=out,
                        bench=bench, base=base)
    lim = limits(name, base)
    for row in rows:
        over = [k for k in lim if k in row and row[k] > lim[k]]
        assert over, (row["control"], row, lim)


def _run(bench, name, seed=5, base=harness.HERE):
    out, err = io.StringIO(), io.StringIO()
    run = harness.Run(bench, name, seed, 0.3, False, device="cpu",
                      overrides=TINY, base=base)
    res = harness.execute(run, time.perf_counter(), out=out, err=err)
    return res, err.getvalue()


@pytest.mark.parametrize("name", ["wdl_criteo.sched_churn",
                                  "wdl_criteo.plain_stream"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_faults_read_incorrect(bench, name, fault):
    with faults.plant(fault):
        res, err = _run(bench, name)
    assert res["correct"] is False, err


@pytest.mark.parametrize("fault", ["dropped_pull", "swapped_flush"])
def test_planner_faults_read_incorrect(bench, fault):
    with faults.plant(fault):
        res, err = _run(bench, "wdl_criteo.sched_churn")
    assert res["correct"] is False, err


def test_altered_score_reads_incorrect(serve_bench):
    bench, base = serve_bench
    with faults.plant("altered_score"):
        res, err = _run(bench, SERVE_CELL, base=base)
    assert res["correct"] is False, err
