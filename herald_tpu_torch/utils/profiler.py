"""Profiling utilities (port of `herald_tpu/utils/profiler.py`):
`StepTimer` (per-step wall times), `trace` (an op-level trace through
`torch.profiler`, where JAX's wraps `jax.profiler`), `comm_stats` (the
static all-to-all bytes a step from the engine's exchange spec),
`cache_report` (planner counters), and the program's spans.

`span(name, **counts)` marks a stretch of the host's work inside the
program. While no `torch.profiler` session records the calling thread it
makes one check and returns a shared no-op context: no clock read, no
record. While one does, it opens `record_function("herald.<name>")`, so
the span lands in that session's trace on the clock of the card's
kernels, and appends a `SpanRecord` to a store of the last `SPAN_LIMIT`
(65,536) records, which `take_spans()` empties. The profiler being on is
the only switch. The spans, and the counts on their records:

- `train.chunk`, the root: one call of `Engine.train_epoch` or
  `CachedEngine.train_epoch_cached`. It opens a new chunk number, which
  every span inside it carries.
- `planner.pop`: `CachePlanner.pop_chunk`'s allocation and C call.
  `queue_before`: programs queued before the call; `K`: programs popped;
  `plan_us`: the planner's planning time so far, the sum of
  `phase_times_us()` after the call.
- `stage.program`: `CachedEngine._chunk_program`, the chunk's step
  inputs and write lists.
- `stage.pack`: the rest of `_stage_chunk`: the pack into pinned memory,
  then the memo and the copy.
- `stage.memo`: `_memo_stage`'s key, compare and copy, while the memo is
  on.
- `stage.copy`: the enqueue of the chunk's host-to-device copy.
- `feed.pack`: `Engine.train_epoch`'s pack of its inputs.
- `step.dispatch`: the replays of one chunk's steps (`_run_chunk`,
  `_train_steps`).
- `launch.stage_wait`: `_Prestager.get`, the launcher's wait for its
  queue and for the staging of the chunk it takes.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch


class StepTimer:
    """Wall-time stats per timed block (mirrors the per-minibatch timing
    the reference entry scripts print). The first `warmup` blocks are not
    kept. A block ends when the host returns, not when the device has
    finished its work."""

    def __init__(self, warmup: int = 5):
        self.warmup = warmup
        self.times: List[float] = []
        self._count = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    def report(self) -> Dict[str, float]:
        if not self.times:
            return {"steps": 0}
        t = np.asarray(self.times)
        return {
            "steps": len(t),
            "total_s": float(t.sum()),
            "avg_ms": float(t.mean() * 1e3),
            "max_ms": float(t.max() * 1e3),
            "min_ms": float(t.min() * 1e3),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p99_ms": float(np.percentile(t, 99) * 1e3),
        }


def start_trace(device):
    """A started torch.profiler session: CPU ops, and the card's kernels
    when `device` is a card."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


@contextlib.contextmanager
def trace(log_dir: str, device="cpu"):
    """Trace the block into `<log_dir>/trace.json`, a Chrome trace
    (chrome://tracing, Perfetto)."""
    prof = start_trace(device)
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def comm_stats(engine, dtype_bytes: int = 4) -> Dict[str, float]:
    """Static per-step all-to-all traffic estimate from the exchange spec."""
    spec = engine.exchange
    S, C, W = spec.num_shards, spec.capacity, engine.width
    id_bytes = S * C * 8
    vec_bytes = S * C * W * dtype_bytes
    return {
        "num_shards": S,
        "capacity_per_pair": C,
        "a2a_id_bytes_per_step": id_bytes,
        "a2a_vector_bytes_per_step": vec_bytes,
        "a2a_total_bytes_per_step": 2 * id_bytes + 2 * vec_bytes,
    }


def cache_report(planner, num_steps: int, ids_per_step: int
                 ) -> Dict[str, float]:
    """Summarize planner counters like CacheSparseTable.overall_miss_rate /
    overall_data_rate (`python/hetu/cstable.py:202-224`): transfer counts
    relative to the vanilla pull-everything-every-step baseline."""
    p = planner.perf()
    total_unique = max(num_steps * ids_per_step, 1)
    pulls = p["miss_pull"] + p["update_pull"]
    pushes = p["miss_push"] + p["update_push"]
    return {
        **p,
        "miss_rate": pulls / total_unique,
        "data_rate": (pulls + pushes) / (2 * total_unique),
        "plan_time_us": planner.iter_time_us(),
    }


# ----------------------------------------------------------------------
# spans
# ----------------------------------------------------------------------

# records kept at most: about 9,000 chunks of the scheduled loop (7 spans
# a chunk) or 20,000 of the plain one (3); a launcher traced over a whole
# run under --log-dir keeps the last ones, in bounded memory
SPAN_LIMIT = 1 << 16
ROOT = "train.chunk"


class SpanRecord(NamedTuple):
    name: str               # without the "herald." of its annotation
    parent: Optional[str]   # the span open around it on its thread
    chunk: Optional[int]    # its root's chunk number; None outside a root
    start_ns: int           # time.perf_counter_ns at entry and exit
    end_ns: int
    counts: Dict[str, int]


_records = collections.deque(maxlen=SPAN_LIMIT)
_chunk_numbers = itertools.count()
_open = threading.local()       # .stack: the spans open on this thread
_profiling = torch._C._autograd._profiler_enabled


class _Off:
    """The span while no profiler records this thread: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, value, tb):
        return None

    def __bool__(self):
        return False


_OFF = _Off()


class _Span:
    """A span while a profiler records this thread. `counts` may be added
    to inside the `with` block."""
    __slots__ = ("name", "counts", "parent", "chunk", "start_ns", "_rf")

    def __init__(self, name: str, counts: Dict[str, int]):
        self.name, self.counts = name, counts

    def __enter__(self):
        stack = _open.__dict__.setdefault("stack", [])
        top = stack[-1] if stack else None
        self.parent = top.name if top is not None else None
        self.chunk = (next(_chunk_numbers) if self.name == ROOT
                      else top.chunk if top is not None else None)
        stack.append(self)
        self._rf = torch.profiler.record_function("herald." + self.name)
        self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, typ, value, tb):
        end = time.perf_counter_ns()
        self._rf.__exit__(typ, value, tb)
        _open.stack.pop()
        _records.append(SpanRecord(self.name, self.parent, self.chunk,
                                   self.start_ns, end, self.counts))
        return None


def span(name: str, **counts):
    """A context over a stretch of the program's host work, named
    `herald.<name>` in a profiler's trace (the names in the module's
    docstring). Falsy, and a no-op, while no profiler records the
    calling thread: compute counts only under `if sp:`."""
    if not _profiling():
        return _OFF
    return _Span(name, counts)


def spanned(name: str):
    """A decorator: each call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def take_spans() -> List[SpanRecord]:
    """The span records kept so far, oldest first; the store is emptied."""
    out = []
    while True:     # record by record: a span may close on another thread
        try:
            out.append(_records.popleft())
        except IndexError:
            return out
