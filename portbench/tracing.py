"""Reduction of a torch.profiler trace (its exported Chrome events) over
the traced stretch: device busy time as the union of every device
operation's interval, device time by kernel and by operation, and the
idle gaps between device operations, each named by the innermost host
span (`portbench.<name>` annotations of `Run.span`) open at its middle.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Optional, Tuple

from portbench import roofline

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STRETCH = "portbench.traced"


class Trace:
    def __init__(self, ops: List[Tuple[float, float, str]],
                 spans: List[Tuple[float, float, str]], t0: float,
                 t1: float):
        self.t0, self.t1 = t0, t1
        self.window_s = (t1 - t0) * 1e-6
        self.ops = ops                  # (start us, end us, name)
        self.spans = spans
        self.by_name = defaultdict(float)
        self.by_kernel = defaultdict(float)
        for a, b, name in ops:
            self.by_name[name] += (b - a) * 1e-6
            k = roofline.kernel_of(name)
            if k:
                self.by_kernel[k] += (b - a) * 1e-6
        merged = []
        for a, b, _ in sorted(ops):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        edges = [t0] + [x for ab in merged for x in ab] + [t1]
        self.gaps = [(edges[i], edges[i + 1])
                     for i in range(0, len(edges) - 1, 2)
                     if edges[i + 1] > edges[i]]

    def kernel_s(self, key: str) -> float:
        return self.by_kernel.get(key, 0.0)

    def top_ops(self, n: int):
        return [[name, s] for name, s in sorted(
            self.by_name.items(), key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t: float) -> str:
        best = None
        for a, b, name in self.spans:
            if a <= t <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        return best[2] if best else "outside any span"

    def top_gaps(self, n: int):
        longest = sorted(self.gaps, key=lambda g: g[0] - g[1])[:n]
        return [[self._host_at((a + b) / 2), (b - a) * 1e-6]
                for a, b in longest]


def summarize(events) -> Optional[Trace]:
    """The Trace of the stretch the `portbench.traced` annotation spans,
    or None where the trace holds no such annotation."""
    spans = [(e["ts"], e["ts"] + e.get("dur", 0),
              e["name"][len("portbench."):])
             for e in events if e.get("ph") == "X"
             and str(e.get("name", "")).startswith("portbench.")]
    stretch = [s for s in spans if s[2] == STRETCH[len("portbench."):]]
    if not stretch:
        return None
    t0, t1, _ = stretch[0]
    ops = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0))
        a, b = max(a, t0), min(b, t1)
        if b > a:
            ops.append((a, b, str(e["name"])))
    inner = [s for s in spans if s[2] != STRETCH[len("portbench."):]]
    return Trace(ops, inner, t0, t1)
