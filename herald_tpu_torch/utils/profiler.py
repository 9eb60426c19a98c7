"""Profiling utilities (port of `herald_tpu/utils/profiler.py`):
`StepTimer` (per-step wall times), `trace` (an op-level trace through
`torch.profiler`, where JAX's wraps `jax.profiler`), `comm_stats` (the
static all-to-all bytes a step from the engine's exchange spec) and
`cache_report` (planner counters).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

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
