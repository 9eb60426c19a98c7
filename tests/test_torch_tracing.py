"""The program's spans (`herald_tpu_torch/utils/profiler.py` `span`,
`take_spans`) on the CPU: off, a span makes no record and never enters
`record_function`; under `torch.profiler` the chunk loops of
`CachedEngine.train_epoch_cached` (a small live planner) and
`Engine.train_epoch` give `herald.*` annotations in the exported trace,
nested and ordered as the loops run, and records that carry their chunk,
with the planner's counts on its pop alone; the store keeps at most `SPAN_LIMIT`
records; and training is bit-identical with the profiler on and off
(wdl_criteo, 8,000 rows, embedding 8, batch 16)."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from herald_tpu_torch import Engine, HeraldConfig
from herald_tpu_torch.data.datasets import synthetic_ctr_data
from herald_tpu_torch.models import get_model
from herald_tpu_torch.train.cached import CachedEngine
from herald_tpu_torch.utils import profiler

ROWS, B, K = 8000, 16, 4
CHUNKS = 3


@pytest.fixture(autouse=True)
def _empty_store():
    profiler.take_spans()
    yield
    profiler.take_spans()


def _data():
    return synthetic_ctr_data(get_model("wdl_criteo").spec, B * K * CHUNKS,
                              seed=4, num_rows=ROWS)


def _cfg(**kw):
    return HeraldConfig(model="wdl_criteo", batch_size=B, embedding_dim=8,
                        learning_rate=0.1, **kw)


def _trace(prof, tmp_path):
    """The `herald.*` annotations of a profiler's exported trace, as
    (start, end, name without "herald.", thread), by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"][len("herald."):],
                   e["tid"]) for e in events if e.get("ph") == "X"
                  and str(e.get("name", "")).startswith("herald."))


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _children(spans, parent):
    """Names of the spans inside `parent`, in order of their start."""
    return [s[2] for s in spans if s is not parent and _inside(s, parent)]


def _cached_run(traced: bool):
    """CHUNKS chunks of K steps through `train_epoch_cached` with its live
    planner, the planner done planning before the first pop: (losses,
    state, the pops' outputs, the staged chunks, the profiler)."""
    d, s, y = _data()
    eng = CachedEngine(_cfg(cache_limit_ratio=0.1), table_rows=ROWS,
                       device="cpu")
    st = eng.init_cached_state(0)
    pl = eng.make_planner(s, epochs=1, n_threads=1)
    deadline = time.monotonic() + 60
    while pl.queue_length() < K * CHUNKS:     # its whole stream queued
        assert time.monotonic() < deadline
        time.sleep(0.01)
    dev = eng.stage_dataset(d, s, y)
    pops, staged = [], []
    real_pop, real_stage = pl.pop_chunk, eng._stage_chunk
    pl.pop_chunk = lambda k: pops.append(real_pop(k)) or pops[-1]
    eng._stage_chunk = lambda *a, **kw: (
        staged.append(real_stage(*a, **kw)) or staged[-1])
    prof = profile(activities=[ProfilerActivity.CPU]) if traced else None
    losses = []
    if prof is not None:
        prof.start()
    try:
        for _ in range(CHUNKS):
            st, stats = eng.train_epoch_cached(st, pl, None, None, None,
                                               steps=K, device_data=dev)
            losses.append(stats["loss"])
    finally:
        if prof is not None:
            prof.stop()
    pl.close()
    return torch.cat(losses), st, pops, staged, prof


def test_span_off_makes_no_record_and_enters_no_annotation(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiler.span("train.chunk", K=3) as sp:
        assert not sp
        with profiler.span("planner.pop") as inner:
            assert inner is sp      # one shared no-op
    assert profiler.take_spans() == []


def test_cached_chunks_nest_in_the_trace(tmp_path):
    *_, prof = _cached_run(traced=True)
    spans = _trace(prof, tmp_path)
    assert len({t for *_, t in spans}) == 1     # the loop's own thread
    roots = [x for x in spans if x[2] == "train.chunk"]
    assert len(roots) == CHUNKS
    for root in roots:
        kids = _children(spans, root)
        # the memo is on by default: the copy inside it, inside the pack
        assert kids == ["planner.pop", "stage.program", "stage.pack",
                        "stage.memo", "stage.copy", "step.dispatch"]
        pack = next(x for x in spans if x[2] == "stage.pack"
                    and _inside(x, root))
        assert _children(spans, pack) == ["stage.memo", "stage.copy"]


def test_cached_records_carry_the_chunk_and_the_counts():
    _, _, pops, staged, _ = _cached_run(traced=True)
    recs = profiler.take_spans()
    roots = [r for r in recs if r.name == "train.chunk"]
    assert len(roots) == CHUNKS
    assert len({r.chunk for r in roots}) == CHUNKS
    for i, root in enumerate(roots):
        mine = [r for r in recs if r.chunk == root.chunk]
        assert {r.name for r in mine} == {
            "train.chunk", "planner.pop", "stage.program", "stage.pack",
            "stage.memo", "stage.copy", "step.dispatch"}
        assert all(root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
                   for r in mine)
        by = {r.name: r for r in mine}
        assert by["train.chunk"].parent is None
        assert by["stage.copy"].parent == "stage.memo"
        assert by["stage.memo"].parent == "stage.pack"
        assert {by[n].parent for n in ("planner.pop", "stage.program",
                                       "stage.pack", "step.dispatch")} \
            == {"train.chunk"}
        # the whole stream was queued before the first pop
        pop = by["planner.pop"].counts
        assert set(pop) == {"queue_before", "K", "plan_us"}
        assert pop["queue_before"] == K * (CHUNKS - i)
        assert pop["K"] == pops[i][0] == staged[i].K == K
        # the planner's counts are the only ones a chunk records
        assert all(r.counts == {} for r in mine if r is not by["planner.pop"])
    # the planner had finished: its planning time read after each pop
    plan = [r.counts["plan_us"] for r in recs if r.name == "planner.pop"]
    assert len(set(plan)) == 1


def test_plain_chunk_nests_in_the_trace_and_records(tmp_path):
    d, s, y = _data()
    eng = Engine(_cfg(), table_rows=ROWS, device="cpu")
    st = eng.init_state(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st, _ = eng.train_epoch(st, d[:B * K], s[:B * K], y[:B * K],
                                steps=K)
    spans = _trace(prof, tmp_path)
    (root,) = [x for x in spans if x[2] == "train.chunk"]
    assert _children(spans, root) == ["feed.pack", "step.dispatch"]
    recs = {r.name: r for r in profiler.take_spans()}
    assert set(recs) == {"train.chunk", "feed.pack", "step.dispatch"}
    assert recs["train.chunk"].parent is None
    assert {recs[n].parent for n in ("feed.pack", "step.dispatch")} \
        == {"train.chunk"}
    assert all(r.counts == {} for r in recs.values())
    assert len({r.chunk for r in recs.values()}) == 1


def test_the_store_keeps_at_most_its_limit():
    assert profiler._records.maxlen == profiler.SPAN_LIMIT
    n = profiler.SPAN_LIMIT + 5
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(n):
            with profiler.span("step.dispatch", steps=i):
                pass
    recs = profiler.take_spans()
    assert len(recs) == profiler.SPAN_LIMIT
    assert recs[0].counts["steps"] == 5 and recs[-1].counts["steps"] == n - 1
    assert profiler.take_spans() == []


def test_training_is_bit_identical_with_the_profiler_on():
    off = _cached_run(traced=False)
    on = _cached_run(traced=True)
    assert torch.equal(off[0], on[0])
    for name in ("table", "cache"):
        assert torch.equal(getattr(off[1], name), getattr(on[1], name))
    d, s, y = _data()
    runs = []
    for traced in (False, True):
        eng = Engine(_cfg(), table_rows=ROWS, device="cpu")
        st = eng.init_state(0)
        prof = profile(activities=[ProfilerActivity.CPU])
        if traced:
            prof.start()
        st, stats = eng.train_epoch(st, d, s, y, steps=K * CHUNKS)
        if traced:
            prof.stop()
        runs.append((stats["loss"], st.table))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
