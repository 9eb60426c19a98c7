"""`spans.py` on synthetic Chrome events: self time against nested
spans, idle gaps split over the spans open across them, other threads
ignored, idle in no span counted as outside, the split adding back to
the stretch's idle; None without a trace or without the program's
spans; the planner's counts from span records; and a traced run of each
cell on the CPU that reads every new metric its cell lists."""

import io
import json
import sys
import time
import types
from collections import namedtuple
from types import SimpleNamespace

import pytest
from conftest import TINY

from portbench import harness, spans

TID, OTHER = 7, 8


def _x(name, ts, dur, tid=TID, cat="user_annotation"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "pid": 1,
            "tid": tid, "cat": cat}


def _kernel(ts, dur):
    return _x("k", ts, dur, tid=99, cat="kernel")


# the stretch [0, 100]: a chunk [10, 90] holding a program [20, 40] and a
# dispatch [50, 80]; the card busy over [0, 12], [45, 60] and [85, 92],
# so idle over [12, 45], [60, 85] and [92, 100]
EVENTS = [
    _x("portbench.traced", 0, 100),
    _x("herald.train.chunk", 10, 80),
    _x("herald.stage.program", 20, 20),
    _x("herald.step.dispatch", 50, 30),
    _x("herald.stage.pack", 0, 100, tid=OTHER),      # another thread
    _x("herald.stage.copy", 0, 100, cat="gpu_user_annotation", tid=TID + 1),
    _kernel(0, 12), _kernel(45, 15), _kernel(85, 7),
]


def test_self_time_against_nested_spans():
    s = spans.summarize(EVENTS)
    assert s.inclusive_s["train.chunk"] == pytest.approx(80e-6)
    assert s.self_s["train.chunk"] == pytest.approx(30e-6)
    assert s.self_s["stage.program"] == pytest.approx(20e-6)
    assert s.self_s["step.dispatch"] == s.inclusive_s["step.dispatch"]


def test_gap_split_over_the_spans_open_across_it():
    s = spans.summarize(EVENTS)
    # [12, 45]: chunk 12-20, program 20-40, chunk 40-45; [60, 85]:
    # dispatch 60-80, chunk 80-85; [92, 100]: outside
    assert s.idle_s["stage.program"] == pytest.approx(20e-6)
    assert s.idle_s["train.chunk"] == pytest.approx((8 + 5 + 5) * 1e-6)
    assert s.idle_s["step.dispatch"] == pytest.approx(20e-6)
    assert s.idle_s[spans.OUTSIDE] == pytest.approx(8e-6)
    assert s.unexplained_s() == pytest.approx(26e-6)
    assert s.unexplained_share() == pytest.approx(100 * 26 / 66)


def test_other_threads_and_device_annotations_are_ignored():
    s = spans.summarize(EVENTS)
    assert set(s.inclusive_s) == {"train.chunk", "stage.program",
                                  "step.dispatch"}


def test_the_split_adds_back_to_the_stretchs_idle():
    s = spans.summarize(EVENTS)
    idle = sum(b - a for a, b in s.trace.gaps) * 1e-6
    assert s.idle_total_s() == idle
    assert s.trace.window_s - s.trace.busy_s == pytest.approx(idle)
    # and with spans crossing the stretch's ends, clipped to it
    clipped = spans.summarize(EVENTS + [_x("herald.feed.pack", -5, 9),
                                        _x("herald.feed.pack", 95, 10)])
    assert clipped.idle_total_s() == idle
    assert clipped.inclusive_s["feed.pack"] == pytest.approx(9e-6)
    assert clipped.idle_s[spans.OUTSIDE] == pytest.approx(3e-6)


def test_none_without_a_trace_or_without_the_programs_spans():
    assert spans.summarize([e for e in EVENTS
                            if e["name"] != "portbench.traced"]) is None
    assert spans.summarize([e for e in EVENTS if e["tid"] != TID
                            or not e["name"].startswith("herald.")]) is None
    r = SimpleNamespace(trace=None, traced=None)
    assert spans.of(r) is None and spans.records(r) is None
    assert spans.ms_per_step(r, "planner.pop") is None
    # a profiler whose stretch holds none of the program's spans
    import torch
    from torch.profiler import record_function

    from portbench import tracing
    with torch.profiler.profile() as prof:
        with record_function("portbench.traced"):
            torch.ones(4).sum()
    assert spans.from_profiler(prof, tracing.Trace([], [], 0.0, 1.0)) \
        is None


def test_the_profilers_own_events_give_the_traces_spans(tmp_path):
    """`of` reads the spans from a profiler whose trace the harness has
    exported (a trace exports once), on the trace's clock: as
    `summarize` reads them from the exported events; once a profiler."""
    import torch
    from torch.profiler import record_function

    from portbench import tracing
    x = torch.randn(64, 64)
    with torch.profiler.profile() as prof:
        with record_function("herald.feed.pack"):   # before the stretch
            x @ x
        with record_function("portbench.traced"):
            for _ in range(3):
                with record_function("herald.train.chunk"):
                    with record_function("herald.stage.program"):
                        x @ x
                    with record_function("herald.step.dispatch"):
                        (x @ x).relu_()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    want = spans.summarize(events)
    err = io.StringIO()
    r = SimpleNamespace(trace=tracing.summarize(events),
                        run=SimpleNamespace(err=err),
                        traced=SimpleNamespace(prof=prof, steps=4))
    got = spans.of(r)
    assert got is spans.of(r)
    assert err.getvalue().count("idle by span") == 1
    assert set(got.inclusive_s) == set(want.inclusive_s) == {
        "train.chunk", "stage.program", "step.dispatch"}
    # the exported trace rounds each time to the ns: 2 ends of 3 spans
    for part in ("inclusive_s", "self_s", "idle_s"):
        a, b = getattr(got, part), getattr(want, part)
        assert set(a) == set(b)
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=0, abs=1e-8), (part, k)
    assert spans.ms_per_step(r, "step.dispatch") == pytest.approx(
        want.inclusive_s["step.dispatch"] / 4 * 1e3, rel=0, abs=1e-8 / 4 * 1e3)
    assert spans.ms_per_step(r, "planner.pop") is None


Rec = namedtuple("Rec", "name counts")


def _pop(queue, k, plan):
    return Rec("planner.pop", {"queue_before": queue, "K": k,
                               "plan_us": plan})


def test_planner_counts_from_span_records():
    recs = [_pop(30, 20, 1000), Rec("stage.program", {}),
            _pop(25, 20, 9000), _pop(12, 20, 21000)]
    # planned: 30, 20 + 25 = 45, 40 + 12 = 52: 22 batches in 20 ms
    assert spans.plan_ms_per_batch(recs) == pytest.approx(20 / 22)
    # the last pop found 12 queued and took 20: one of three starved
    assert spans.starved_pop_share(recs) == pytest.approx(100 / 3)
    assert spans.plan_ms_per_batch(recs[:2]) is None
    assert spans.starved_pop_share([]) is None
    assert spans.starved_pop_share(None) is None


def test_records_are_none_for_a_program_without_them(monkeypatch):
    monkeypatch.setitem(sys.modules, "herald_tpu_torch.utils.profiler",
                        types.ModuleType("herald_tpu_torch.utils.profiler"))
    r = SimpleNamespace(traced=SimpleNamespace(prof=object()))
    assert spans.records(r) is None


NEW = {"wdl_criteo.sched_churn": {
    "span_pop_ms_per_step", "span_program_ms_per_step",
    "span_pack_ms_per_step", "span_dispatch_ms_per_step",
    "idle_outside_spans_ms_per_step", "plan_ms_per_batch",
    "planner_starved_pop_share"},
    "wdl_criteo.plain_stream": {"span_dispatch_ms_per_step",
                                "idle_outside_spans_ms_per_step"}}


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_traced_run_reads_every_new_metric_of_its_cell(bench, cell):
    listed = {m["name"] for m in bench["per_layer"]
              if cell in m.get("workloads", ())}
    assert NEW[cell] <= listed
    run = harness.Run(bench, cell, 2**31 + 11, 0.3, True, device="cpu",
                      overrides=TINY)
    out, err = io.StringIO(), io.StringIO()
    res = harness.execute(run, time.perf_counter(), out=out, err=err)
    assert res["correct"], err.getvalue()
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert NEW[cell] <= set(got), err.getvalue()
    assert got["idle_outside_spans_ms_per_step"] >= 0
    assert got["span_dispatch_ms_per_step"] > 0
    if cell.endswith("sched_churn"):
        assert 0 <= got["planner_starved_pop_share"] <= 100
        # the planner times each phase of a batch in whole µs: at this
        # size a busy host can read no change between two pops
        assert got["plan_ms_per_batch"] >= 0
        assert "idle by span" in err.getvalue()
