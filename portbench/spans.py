"""The program's own spans over the traced stretch.

`herald_tpu_torch`'s `utils/profiler.span` leaves `herald.<name>`
annotations in the profiler's trace, on the clock of the card's kernels.
`Spans` keeps those on the thread of the `portbench.traced` annotation,
clipped to the stretch, and gives each span's inclusive time (its
intervals summed) and self time (its intervals less its child spans'),
and splits the card's idle time (`tracing.Trace.gaps`) by the innermost
`herald.*` span open over each part of each gap, `OUTSIDE` where none
is. `summarize` reads them from Chrome trace events. A profiler's trace
can be exported once, and the harness has done so, so `of` reads the
spans from the profiler's own events instead, placed on the trace's
clock by the `portbench.traced` annotation, beside the harness's
`tracing.Trace`. `records` gives the program's span records of the
stretch (`take_spans()`, with the planner's counts). Both are taken once
per reading, and kept on it; a program without the spans reads None from
both.
"""

from __future__ import annotations

import sys
from collections import defaultdict
from typing import List, Optional, Tuple

from portbench import tracing

PREFIX = "herald."
OUTSIDE = "outside any span"
ROOT = "train.chunk"


class Spans:
    def __init__(self, spans: List[Tuple[float, float, str]],
                 trace: tracing.Trace):
        self.trace = trace
        self.inclusive_s = defaultdict(float)
        for a, b, name in spans:
            self.inclusive_s[name] += (b - a) * 1e-6
        self.segments = _segments(spans, trace.t0, trace.t1)
        self.self_s = defaultdict(float)
        for a, b, name in self.segments:
            if name != OUTSIDE:
                self.self_s[name] += (b - a) * 1e-6
        self.idle_s = defaultdict(float)
        i = 0
        for ga, gb in trace.gaps:
            while self.segments[i][1] <= ga:
                i += 1
            j = i
            while j < len(self.segments) and self.segments[j][0] < gb:
                a, b, name = self.segments[j]
                self.idle_s[name] += (min(b, gb) - max(a, ga)) * 1e-6
                j += 1

    def idle_total_s(self) -> float:
        return sum(self.idle_s.values())

    def unexplained_s(self) -> float:
        """Seconds of the idle time in no span or in the root's own time:
        what the program's spans leave unexplained."""
        return self.idle_s[OUTSIDE] + self.idle_s[ROOT]

    def unexplained_share(self) -> Optional[float]:
        """`unexplained_s` as a percent of the idle time."""
        total = self.idle_total_s()
        if total <= 0:
            return None
        return 100.0 * self.unexplained_s() / total

    def table(self, steps: int) -> str:
        """The idle split, ms a step and share, largest first."""
        total = self.idle_total_s()
        rows = sorted(self.idle_s.items(), key=lambda kv: -kv[1])
        return "; ".join(
            f"{name} {s / steps * 1e3:.4f} ms {100 * s / total:.1f}%"
            for name, s in rows) if steps and total > 0 else ""


def _segments(spans, t0: float, t1: float):
    """[t0, t1] cut where spans open and close: (start, end, the
    innermost span open there, or OUTSIDE), in order. The spans of one
    thread nest; where rounding lets a child outlast its parent by a
    hair, the child keeps the overlap."""
    out = []
    stack = []      # (end, name), innermost last
    cur = t0
    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            end, inner = stack.pop()
            if end > cur:
                out.append((cur, end, inner))
                cur = end
        if a > cur:
            out.append((cur, a, stack[-1][1] if stack else OUTSIDE))
            cur = a
        stack.append((b, name))
    while stack:
        end, inner = stack.pop()
        if end > cur:
            out.append((cur, end, inner))
            cur = end
    if t1 > cur:
        out.append((cur, t1, OUTSIDE))
    return out


def summarize(events) -> Optional[Spans]:
    """The program's spans of a Chrome trace's stretch, or None where the
    trace has no stretch or the stretch's thread no `herald.*` span."""
    trace = tracing.summarize(events)
    if trace is None:
        return None
    where = next(((e.get("pid"), e.get("tid")) for e in events
                  if e.get("ph") == "X" and e.get("name") == tracing.STRETCH
                  and e.get("cat") != "gpu_user_annotation"), None)
    return _spans([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    str(e["name"])) for e in events
                   if e.get("ph") == "X"
                   and str(e.get("name", "")).startswith(PREFIX)
                   and (e.get("pid"), e.get("tid")) == where], trace)


def _spans(found, trace) -> Optional[Spans]:
    """`found` (start us, end us, full name), clipped to the stretch."""
    spans = [(max(a, trace.t0), min(b, trace.t1), name[len(PREFIX):])
             for a, b, name in found]
    spans = [x for x in spans if x[1] > x[0]]
    return Spans(spans, trace) if spans else None


def from_profiler(prof, trace) -> Optional[Spans]:
    """The program's spans from a stopped profiler's events, on the thread
    of the stretch's host annotation. The profiler's events share one
    clock with its trace, shifted: the stretch's annotation whose length
    is the trace's stretch (the host's, or the card's side of it) pins
    the shift."""
    import torch
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith((PREFIX, tracing.STRETCH))]
    stretch = [e for e in events if e.name() == tracing.STRETCH]
    host = [e for e in stretch
            if e.device_type() == torch.autograd.DeviceType.CPU]
    if not host:
        return None
    pin = min(stretch, key=lambda e: abs(
        e.duration_ns() * 1e-3 - (trace.t1 - trace.t0)))
    t0, tid = pin.start_ns(), host[0].start_thread_id()
    return _spans([(trace.t0 + (e.start_ns() - t0) * 1e-3,
                    trace.t0 + (e.end_ns() - t0) * 1e-3, e.name())
                   for e in events if e.name().startswith(PREFIX)
                   and e.device_type() == host[0].device_type()
                   and e.start_thread_id() == tid], trace)


def _once(what: str, r, make):
    """`make()`, once per reading `r`: kept on it as `r.herald_<what>`."""
    key = "herald_" + what
    if not hasattr(r, key):
        setattr(r, key, make())
    return getattr(r, key)


def of(r) -> Optional[Spans]:
    """The traced stretch's spans, once per reading; the idle split, and
    its unexplained share, go to the run's error stream once."""
    if r.trace is None or r.traced is None:
        return None

    def make():
        s = from_profiler(r.traced.prof, r.trace)
        if s is not None:
            print(f"idle by span over {r.traced.steps} steps: "
                  f"{s.table(r.traced.steps)}; unexplained "
                  f"{s.unexplained_share()}%", file=getattr(
                      r.run, "err", sys.stderr))
        return s
    return _once("spans", r, make)


def records(r):
    """The program's span records of the traced stretch (all it kept
    while the profiler ran), taken once per reading; None where the
    program keeps none."""
    if r.traced is None:
        return None

    def make():
        try:
            from herald_tpu_torch.utils.profiler import take_spans
        except ImportError:
            return None
        return take_spans()
    return _once("records", r, make)


def ms_per_step(r, name: str, own: bool = False) -> Optional[float]:
    """Inclusive (or, with `own`, self) ms a step in the span `name`
    over the traced stretch; None where it never ran."""
    s = of(r)
    if s is None or not r.traced.steps or name not in s.inclusive_s:
        return None
    return (s.self_s if own else s.inclusive_s)[name] / r.traced.steps * 1e3


def pops(recs) -> list:
    return [x for x in recs or () if x.name == "planner.pop"
            and "plan_us" in x.counts]


def plan_ms_per_batch(recs) -> Optional[float]:
    """The planner's planning ms a batch between the first and the last
    pop: the change of its planning time (`plan_us`, read after each
    pop) over the change of the batches it had planned (`queue_before`
    plus the programs popped before)."""
    ps = pops(recs)
    if len(ps) < 2:
        return None
    popped = sum(p.counts["K"] for p in ps[:-1])
    planned = popped + ps[-1].counts["queue_before"] \
        - ps[0].counts["queue_before"]
    if planned <= 0:
        return None
    return (ps[-1].counts["plan_us"] - ps[0].counts["plan_us"]) / planned \
        * 1e-3


def starved_pop_share(recs) -> Optional[float]:
    """Percent of the pops that found fewer programs queued than they
    took: the steps caught up with the planner, and the pop waited for
    it to plan."""
    ps = pops(recs)
    if not ps:
        return None
    return 100.0 * sum(p.counts["queue_before"] < p.counts["K"]
                       for p in ps) / len(ps)
