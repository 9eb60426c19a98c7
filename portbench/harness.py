"""One run of one cell: set-up, the measured window, the traced stretch,
the per-layer readers, the check against the reference, the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name: `configs/<config>.json`, `mixes/<traffic>.json`
(whose "driver" names `drivers/<driver>.py`), `metrics/<metric>.py` and
`limits/<workload>.json`. A driver's `Workload(run)` does the set-up
(weights and inputs from the seed, the program's first steps for the
check, the warm-up); then `unit()` runs one piece of the window's work
and returns its steps, `close()` waits for it (and returns the steps of
any work it finishes), `free()` lets the program's state go, and
`judge()` compares with the reference; `start()` opens the window.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent
# top-level module names no run may load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "herald_tpu")
# units run under the profiler in a traced run, and where they start
TRACE_AT = 0.4
PAD_LAUNCHES = 256


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def forbidden_modules():
    """Top-level names of loaded modules that no run may load."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Run:
    """What a driver gets: the cell, its configuration and mix, the
    seed, the device, host spans and the switches of the traced stretch."""

    def __init__(self, bench: dict, workload: str, seed: int,
                 seconds: float, trace: bool, device: str = "cuda",
                 overrides: Optional[dict] = None, base: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"known: {sorted(cells)}")
        self.bench = bench
        self.cell = cells[workload]
        self.config_entry = next(c for c in bench["configs"]
                                 if c["name"] == self.cell["config"])
        ov = overrides or {}
        self.base = base
        self.cfg = {**read_json(base.parent / self.config_entry["file"]),
                    **ov.get("config", {})}
        self.mix = {**read_json(base / "mixes" / f"{self.cell['traffic']}"
                                f".json"), **ov.get("mix", {})}
        self.limits = read_json(base / "limits" / f"{workload}.json")
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device = device
        self.spans: Dict[str, float] = defaultdict(float)
        self.setup_spans: Dict[str, float] = {}
        self.err = sys.stderr       # where drivers print what they find
        self.recording = False      # inside the traced stretch
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str):
        """Host seconds of a call, summed by name; under the profiler an
        annotation of that name in the trace instead (the profiler slows
        the host, so its stretch is left out of the sums)."""
        if self.profiling:
            import torch
            with torch.profiler.record_function(f"portbench.{name}"):
                yield
            return
        t = time.perf_counter()
        yield
        self.spans[name] += time.perf_counter() - t

    def sync(self) -> None:
        import torch
        if self.device != "cpu":
            torch.cuda.synchronize()

    def driver(self):
        return load_module(self.base / "drivers" / f"{self.mix['driver']}.py",
                           f"portbench_driver_{self.mix['driver']}")

    def reference(self):
        return load_module(self.base / "reference" /
                           f"{self.cfg['reference']}.py",
                           f"portbench_reference_{self.cfg['reference']}")

    def metric_entries(self):
        """The per-layer metrics that list this cell."""
        return [m for m in self.bench["per_layer"]
                if self.cell["name"] in m.get("workloads", ())]

    def metric_reader(self, name: str) -> ModuleType:
        """`metrics/<name>.py`, or where there is none the reader of the
        name's stem, `metrics/<name up to its first dot>.py`: one reader
        serves `step_mfu.train` and `step_mfu.serve`."""
        path = self.base / "metrics" / f"{name}.py"
        if not path.exists():
            path = self.base / "metrics" / f"{name.split('.')[0]}.py"
        return load_module(path, f"portbench_metric_{path.stem}")

    def end_to_end_entries(self):
        return [m for m in self.bench["end_to_end"]
                if self.cell["name"] in m.get("workloads",
                                              [self.cell["name"]])]


def _profile_units(run: Run, work, units: int):
    """Run `units` units under torch.profiler: (steps run, the profiler,
    host seconds of the stretch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if run.device != "cpu":
        acts.append(ProfilerActivity.CUDA)
    run.sync()
    steps = 0
    t = time.perf_counter()
    with profile(activities=acts) as prof:
        # the first launches under a profiler can lose their device records:
        # spend that on spin launches outside the measured stretch
        if run.device != "cpu":
            for _ in range(PAD_LAUNCHES):
                torch.cuda._sleep(1)
            run.sync()
        run.profiling = run.recording = True
        with run.span("traced"):
            for _ in range(units):
                steps += work.unit()
            steps += work.close()
            run.sync()
        run.profiling = run.recording = False
    return steps, prof, time.perf_counter() - t


def _trace_events(prof) -> list:
    """The profiler's trace as Chrome trace events."""
    path = Path(tempfile.gettempdir()) / f"portbench_trace_{id(prof)}.json"
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text())
    finally:
        path.unlink(missing_ok=True)
    return events.get("traceEvents", []) if isinstance(events, dict) \
        else events


def execute(run: Run, t_start: float, out=sys.stdout, err=sys.stderr):
    """One run: returns the result dict (also printed as the last line of
    `out`), or raises."""
    import torch

    from portbench import tracing

    run.err = err
    before = time.perf_counter() - t_start     # imports, the card's context
    with run.span("driver_setup"):
        work = run.driver().Workload(run)
        run.sync()
    setup_s = time.perf_counter() - t_start
    run.setup_spans = {"before_driver": before, **run.spans}
    run.spans.clear()
    captures0 = work.captures()
    start = work.counters()

    traced = None
    units = steps = 0
    work.start()
    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    trace_at = t0 + TRACE_AT * run.seconds if run.trace else None
    with run.span("window"):
        while time.perf_counter() < deadline or trace_at is not None:
            # the traced stretch starts TRACE_AT into the window, or at
            # its end where a unit outlasts that
            if trace_at is not None and time.perf_counter() >= trace_at:
                trace_at = None
                n = run.mix["trace_units"]
                s, prof, host_s = _profile_units(run, work, n)
                traced = SimpleNamespace(units=n, steps=s, prof=prof,
                                         host_s=host_s)
                units += n
                steps += s
                continue
            steps += work.unit()
            units += 1
        steps += work.close()
        run.sync()
    window_s = time.perf_counter() - t0
    if work.captures() != captures0:
        raise RuntimeError(f"{work.captures() - captures0} step graphs "
                           f"were captured inside the window: the "
                           f"warm-up missed a shape")
    counters = {k: v - start.get(k, 0) for k, v in work.counters().items()}

    peak = torch.cuda.max_memory_allocated() if run.device != "cpu" else 0
    e2e = work.end_to_end(window_s, steps)
    e2e["setup_s"] = setup_s
    metrics = {}
    want_e2e = {m["name"]: m for m in run.end_to_end_entries()}
    result_device = {
        "platform": "gpu" if run.device != "cpu" else "cpu",
        "kind": (torch.cuda.get_device_name(0) if run.device != "cpu"
                 else "cpu"),
        "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if run.trace:
        tr = tracing.summarize(_trace_events(traced.prof)) if traced \
            else None
        # host spans, steps and seconds of the window outside the traced
        # stretch, which the profiler slows
        off = (traced.steps, traced.host_s) if traced else (0, 0.0)
        reading = SimpleNamespace(
            run=run, cfg=run.cfg, mix=run.mix,
            window_s=window_s - off[1], steps=steps - off[0],
            window_steps=steps,
            spans=dict(run.spans),
            counters=counters, peak_bytes=peak, trace=tr, traced=traced,
            work=work.kernel_work() if traced else {},
            step_flops=work.step_flops())
        for m in run.metric_entries():
            v = run.metric_reader(m["name"]).read(reading)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if tr is not None:
            result_device["busy_s"] = tr.busy_s
            result_device["window_s"] = tr.window_s
            breakdown = {"device_ops": tr.top_ops(10),
                         "idle_gaps": tr.top_gaps(10)}
    else:
        for name, m in want_e2e.items():
            metrics[name] = {"value": float(e2e[name]), "unit": m["unit"]}

    work.free()
    gc.collect()
    if run.device != "cpu":
        torch.cuda.empty_cache()
    checks = run_checks(run, work.judge(), err)
    del work
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules that the benchmark may not load are "
                           f"loaded: {found}")
    print("setup split (s): " + json.dumps(run.setup_spans), file=err)
    print(f"window: {units} units, {steps} steps, {window_s:.4f} s; "
          f"end to end: {json.dumps(e2e)}", file=err)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=err)
    result = {"correct": bool(correct), "attempted": int(steps),
              "failed": 0, "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    print(json.dumps(result), file=out, flush=True)
    return result


def run_checks(run: Run, numbers: dict, err=sys.stderr) -> dict:
    """{name: {"value", "limit"}} of the numbers the workload's judge gave
    that `limits/<workload>.json` holds a limit for; a number that is not
    finite reads as infinite. The judge's other numbers go to `err`."""
    out = {}
    for name, value in numbers.items():
        v = float(value)
        if v != v:
            v = float("inf")
        if name in run.limits:
            out[name] = {"value": v, "limit": float(run.limits[name])}
        else:
            print(f"reading {name}: {v!r}", file=err)
    missing = set(run.limits) - set(out)
    if missing:
        raise RuntimeError(f"the judge gave no {sorted(missing)}")
    return out
