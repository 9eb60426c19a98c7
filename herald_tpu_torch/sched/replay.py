"""Plan recording + replay: run the planner once, train from its tape.

The port's own copy of `herald_tpu/sched/replay.py`, with the same tape
format (`_TAPE_FMT` 2, the same `.npy` names and `meta.json`) and the same
key, so a tape recorded by either package replays in the other.

Planning is deterministic given (ids, config) — that is what makes
mid-epoch resume work (`planner.fast_forward`) — and the reference
trains a FIXED Laia epoch matrix per job (`laia/src/laia_scheduler.cc`
walks one precomputed sample->ID matrix). So for a fixed stream the
whole micro-program tape can be materialized once and replayed on every
later run, epoch and restart: zero planning cost on the training host's
critical path (the 64-rank planner costs ~160 ms/batch on one core,
~15-25 ms on real multi-core hosts — all of it disappears), and the
replay file is mmap'd so staging reads stream straight from page cache.

    planner = plan_cache(eng, sparse, "plans/wdl", epochs=4)   # records
    ...                                                        # or replays
    state, stats = eng.train_epoch_cached(state, planner, ...)

The tape is keyed by a hash of the id stream + every planner-relevant
config knob; a mismatched tape is re-recorded, never silently reused.
Single-process consumers only (multi-process jobs fan out live programs
through BroadcastPlanner; a follower replaying a file would lose the
one-planner-per-job contract's liveness checks).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np

_ARRAYS = ("assign", "slots", "pulls", "fids", "fslots", "pfids",
           "pfslots", "uniq", "inv")

# bump when the program-array set changes; a mismatched tape is
# re-recorded (fmt 2: host-side dedup added uniq/inv)
_TAPE_FMT = 2


def record_plan(planner, path: str, key: str = "",
                chunk: int = 64) -> "ReplayPlanner":
    """Drain `planner` (a live CachePlanner) into the tape directory
    `path` and return the ReplayPlanner over it. Crash- and race-safe:
    arrays are written into a scratch sibling (`<path>.tmp-<pid>`) and
    atomically renamed into place, meta.json last — a crash leaves no
    half tape behind the complete-marker, and if a concurrent recorder
    (parallel lr sweep) wins the rename, its identical tape is used.
    The live planner is closed."""
    parts = {k: [] for k in _ARRAYS}
    while True:
        out = planner.pop_chunk(chunk)
        K = out[0]
        if K == 0:
            break
        for name, arr in zip(_ARRAYS, out[1:]):
            parts[name].append(np.ascontiguousarray(arr[:K]))
    tmp = f"{path.rstrip(os.sep)}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    T = 0
    for name in _ARRAYS:
        arr = (np.concatenate(parts[name])
               if parts[name] else np.empty((0, 1), np.int32))
        T = len(arr)
        np.save(os.path.join(tmp, f"{name}.npy"), arr)
    for z in range(planner.nrank):
        ids, slots = planner.dirty_rows(z)
        np.save(os.path.join(tmp, f"dirty_ids_{z}.npy"), ids)
        np.save(os.path.join(tmp, f"dirty_slots_{z}.npy"), slots)
    meta = {
        "fmt": _TAPE_FMT,
        "key": key, "steps": T, "nrank": planner.nrank,
        "batch_num": planner.batch_num,     # per-epoch, like the live one
        "mbs": planner.mbs, "U_cap": planner.U_cap,
        "F_cap": planner.F_cap, "P_cap": max(planner.P_cap, 1),
        "cache_rows": planner.cache_rows,
        "perf": {k: int(v) for k, v in planner.perf().items()},
    }
    planner.close()
    # meta last: its presence marks a COMPLETE tape (a crash mid-record
    # leaves no meta and the cache misses)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    try:
        os.rename(tmp, path)
    except OSError:
        # a concurrent recorder won, or a stale tape occupies the path:
        # keep theirs if it matches (identical by determinism), replace
        # it otherwise
        import shutil
        try:
            rp = ReplayPlanner(path, expect_key=key)
        except (ValueError, FileNotFoundError, json.JSONDecodeError):
            shutil.rmtree(path, ignore_errors=True)
            os.rename(tmp, path)
        else:
            shutil.rmtree(tmp, ignore_errors=True)
            return rp
    return ReplayPlanner(path, expect_key=key)


class ReplayPlanner:
    """CachePlanner-compatible consumer over a recorded tape (mmap'd)."""

    def __init__(self, path: str, expect_key: Optional[str] = None):
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        if self.meta.get("fmt") != _TAPE_FMT:
            raise ValueError(
                f"plan tape at {path} has format "
                f"{self.meta.get('fmt')} != {_TAPE_FMT} (pre-host-dedup "
                f"tape): re-record it")
        if expect_key is not None and self.meta["key"] != expect_key:
            raise ValueError(
                f"plan tape at {path} was recorded for a different "
                f"(stream, config): key {self.meta['key']!r} != "
                f"{expect_key!r}")
        self._a = {k: np.load(os.path.join(path, f"{k}.npy"),
                              mmap_mode="r") for k in _ARRAYS}
        self.nrank = int(self.meta["nrank"])
        self.mbs = int(self.meta["mbs"])
        self.U_cap = int(self.meta["U_cap"])
        self.F_cap = int(self.meta["F_cap"])
        self.P_cap = int(self.meta["P_cap"])
        self.cache_rows = int(self.meta["cache_rows"])
        # per-epoch batches (live-planner semantics); the tape holds
        # steps = batch_num * epochs rows
        self.batch_num = int(self.meta.get("batch_num",
                                           self.meta["steps"]))
        self.total_steps = int(self.meta["steps"])
        self._dirty = {
            z: (np.load(os.path.join(path, f"dirty_ids_{z}.npy")),
                np.load(os.path.join(path, f"dirty_slots_{z}.npy")))
            for z in range(self.nrank)}
        self._pos = 0

    def pop_chunk(self, steps: int):
        lo = self._pos
        K = min(steps, self.total_steps - lo)
        self._pos += max(K, 0)
        sl = slice(lo, lo + K)
        return (K,) + tuple(self._a[k][sl] for k in _ARRAYS)

    def fast_forward(self, k: int) -> int:
        done = min(k, self.total_steps - self._pos)
        self._pos += done
        return done

    def dirty_rows(self, worker: int):
        if self._pos < self.total_steps:
            raise RuntimeError(
                "dirty_rows/sync called before the tape was drained: the "
                "dump names (key, slot) pairs for the END of the stream")
        return self._dirty[worker]

    def perf(self) -> dict:
        return dict(self.meta["perf"])

    def queue_length(self) -> int:        # tape: everything is "queued"
        return 0

    def iter_time_us(self) -> int:
        return 0

    def phase_times_us(self) -> dict:
        return {"score": 0, "assign": 0, "plan": 0, "stale": 0}

    def close(self):
        self._a = {}


def plan_key(sparse_ids: np.ndarray, cfg, epochs: int, table_rows: int,
             num_shards: int = 1, planner_kw: Optional[dict] = None
             ) -> str:
    """Tape cache key: the id stream + every knob that shapes programs
    (topology included — a tape is only valid for the worker count it
    was planned for). n_threads/queue_cap are deliberately excluded:
    planning is n_threads-independent by design (quota-partitioned
    greedy; tests/test_stress.py pins it)."""
    h = hashlib.sha256()
    ids = np.ascontiguousarray(sparse_ids, np.int64)
    h.update(ids.tobytes())
    kw = {k: v for k, v in (planner_kw or {}).items()
          if k not in ("n_threads", "queue_cap")}
    fields = (cfg.batch_size, cfg.cache_policy, cfg.cache_limit,
              cfg.cache_limit_ratio, cfg.pinned_rows, cfg.staleness_bound,
              cfg.sched_top_k_tables, cfg.sched_shuffle_seed,
              cfg.sched_unique_slots, cfg.sched_flush_slots,
              cfg.sched_flush_budget, cfg.sched_pull_target,
              cfg.sched_hoist_window, cfg.sched_prefetch_slots,
              cfg.a2a_flush_capacity, epochs, table_rows,
              num_shards, cfg.comm_mode, tuple(cfg.mesh_shape or ()),
              cfg.mp_shards, sorted(kw.items()))
    h.update(repr(fields).encode())
    return h.hexdigest()[:32]


def plan_cache(engine, sparse_ids: np.ndarray, path: str, epochs: int = 1,
               **planner_kw) -> ReplayPlanner:
    """Replay the tape at `path` if it matches (stream, config); record
    it first otherwise. Drop-in for `engine.make_planner` on
    single-process fixed-stream jobs."""
    key = plan_key(sparse_ids, engine.cfg, epochs, engine.num_rows,
                   num_shards=max(engine.num_shards, 1),
                   planner_kw=planner_kw)
    meta_p = os.path.join(path, "meta.json")
    if os.path.exists(meta_p):
        try:
            rp = ReplayPlanner(path, expect_key=key)
            assert rp.nrank == max(engine.num_shards, 1)
            return rp
        except ValueError:
            pass                        # stale tape: re-record below
    live = engine.make_planner(sparse_ids, epochs=epochs, **planner_kw)
    return record_plan(live, path, key=key)
