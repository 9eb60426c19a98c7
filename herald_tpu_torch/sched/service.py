"""One planner for a group of ranks (port of `herald_tpu/sched/service.py`:
its `BroadcastPlanner` and `BroadcastScheduler`).

A run over S ranks plans each global batch once: rank 0 alone runs the
native planner (csrc/herald_cache_planner.cc, `sched/planner.py`) or
lookahead scheduler (csrc/herald_sched.cc, `sched/scheduler.py`) for
`nrank = S` workers, and every rank receives what it pops through the
group's `Comm.broadcast_` (`parallel/comm.py`), which makes one call for
each dtype: on the card under NCCL (which moves only CUDA tensors), on the
host under gloo; one copy back to the host a call either way.

- `BroadcastPlanner` fans out the cached engine's micro-programs: a chunk
  is ten arrays in the planner's device layout (`CachePlanner.pop_chunk`),
  three broadcasts (int64, int32, uint8) a chunk; the dirty-row dumps of
  the final sync are broadcast once, lengths first.
- `BroadcastScheduler` fans out assign-only mode's assignments, one int64
  buffer `[ok, assign[S, B]...]` a pop; the comm plans stay on rank 0:
  assign-only training reads the assignment alone.

Every method but `close` (and `queue_length`, which raises off rank 0) is
a collective: every rank makes the same calls, in the same order, or the
group hangs. Each returns arrays of its own (never a view of a buffer the
next call reuses).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

_PERF_KEYS = ("miss_pull", "miss_push", "update_pull", "update_push")
# the cached planner's counters (JAX's `_PERF_KEYS`)
_PLANNER_PERF_KEYS = _PERF_KEYS + ("deferred_flush", "hoisted_pull")
_TORCH = {np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32,
          np.dtype(np.uint8): torch.uint8}


def broadcast_arrays(comm, arrays: Sequence[Optional[np.ndarray]], shapes,
                     dtypes) -> List[np.ndarray]:
    """Rank 0's `arrays` (None on the other ranks) on every rank of `comm`,
    as host arrays of the given shapes and numpy dtypes, in one broadcast
    for each dtype. No later call reuses them (on rank 0 under gloo they
    are the arrays given)."""
    dev = comm.device if comm.backend == "nccl" else torch.device("cpu")
    ts = [torch.as_tensor(np.asarray(a, dt), device=dev) if a is not None
          else torch.zeros(shape, dtype=_TORCH[np.dtype(dt)], device=dev)
          for a, shape, dt in zip(arrays, shapes, dtypes)]
    comm.broadcast_(ts)
    return [t.cpu().numpy() for t in ts]


class BroadcastPlanner:
    """The `CachePlanner` that `factory()` makes, on rank 0 of `comm`, its
    programs broadcast to every rank: the surface the cached engine and
    the launcher use (`pop_chunk`, `fast_forward`, `dirty_rows`, `perf`,
    `iter_time_us`, `batch_num`, the caps). The other ranks size their
    buffers from the arguments, which rank 0 checks against its planner
    (JAX's `service.py:61-70`)."""

    def __init__(self, factory: Callable, comm, num_samples: int,
                 nrank: int, batch_size: int, unique_cap: int,
                 flush_cap: int, cache_rows: int, epochs: int = 1,
                 drop_last: bool = True, prefetch_cap: int = 0,
                 num_tables: int = 0):
        self.comm = comm
        self._leader = comm.rank == 0
        self.planner = factory() if self._leader else None
        self.nrank, self.mbs = nrank, batch_size
        self.U_cap, self.F_cap = int(unique_cap), int(flush_cap)
        self.P_cap = int(prefetch_cap)
        self.cache_rows = cache_rows
        # the other ranks' inv width needs the table count; rank 0 can
        # read it off its planner
        self.num_tables = int(num_tables) or (
            self.planner.num_tables if self._leader else 0)
        if not self.num_tables:
            raise ValueError(
                "BroadcastPlanner followers need num_tables (the "
                "host-dedup inv buffer width is mbs * num_tables)")
        spw = num_samples // nrank
        self.batch_num = (spw // batch_size if drop_last
                          else int(np.ceil(spw / batch_size)))
        self._dumps = None
        if self._leader:
            pl = self.planner
            assert pl.batch_num == self.batch_num, (pl.batch_num,
                                                    self.batch_num)
            assert pl.U_cap == self.U_cap
            assert pl.F_cap == self.F_cap
            assert pl.P_cap == self.P_cap, (pl.P_cap, self.P_cap)
            assert pl.num_tables == self.num_tables, (pl.num_tables,
                                                      self.num_tables)

    def _bcast(self, arrays, shapes, dtypes) -> List[np.ndarray]:
        return broadcast_arrays(self.comm, arrays, shapes, dtypes)

    def pop_chunk(self, steps: int):
        """Up to `steps` programs, on every rank: (K, assign [steps, S*mbs]
        int64, slots, pulls uint8, fids, fslots, pfids, pfslots, uniq,
        inv), as `CachePlanner.pop_chunk` gives them, the rows past K
        zero."""
        nr, P = self.nrank, max(self.P_cap, 1)
        widths = (nr * self.mbs, nr * self.U_cap, nr * self.U_cap,
                  nr * self.F_cap, nr * self.F_cap, nr * P, nr * P,
                  nr * self.U_cap, nr * self.mbs * self.num_tables)
        shapes = [(1,)] + [(steps, w) for w in widths]
        dtypes = [np.int64, np.int64, np.int32, np.uint8] + [np.int32] * 6
        arrays = [None] * len(shapes)
        if self._leader:
            K, *arrays = self.planner.pop_chunk(steps)
            for a in arrays:    # every byte of the broadcast defined
                a[K:] = 0
            arrays = [np.array([K], np.int64)] + arrays
        K, *out = self._bcast(arrays, shapes, dtypes)
        return (int(K[0]), *out)

    def fast_forward(self, k: int) -> int:
        """Rank 0's planner past the first `k` batches; its count on every
        rank."""
        n = self.planner.fast_forward(k) if self._leader else None
        return int(self._bcast([None if n is None else np.array(
            [n], np.int64)], [(1,)], [np.int64])[0][0])

    def _all_dumps(self):
        """Every worker's residual dirty rows, broadcast once: the lengths,
        then the ids and slots padded to the longest."""
        if self._dumps is not None:
            return self._dumps
        nr = self.nrank
        raw = ([self.planner.dirty_rows(z) for z in range(nr)]
               if self._leader else None)
        lens = np.array([len(i) for i, _ in raw], np.int64) \
            if self._leader else None
        lens = self._bcast([lens], [(nr,)], [np.int64])[0]
        n = max(int(lens.max(initial=0)), 1)
        ids = slots = None
        if self._leader:
            ids = np.full((nr, n), -1, np.int64)
            slots = np.full((nr, n), self.cache_rows, np.int64)
            for z, (i, s) in enumerate(raw):
                ids[z, :len(i)] = i
                slots[z, :len(s)] = s
        ids, slots = self._bcast([ids, slots], [(nr, n)] * 2,
                                 [np.int64] * 2)
        self._dumps = [(ids[z, :lens[z]],
                        slots[z, :lens[z]].astype(np.int32))
                       for z in range(nr)]
        return self._dumps

    def dirty_rows(self, worker: int):
        """Worker `worker`'s residual dirty (ids, slots), on every rank; the
        first call broadcasts every worker's."""
        return self._all_dumps()[worker]

    def perf(self) -> dict:
        """The planner's six counters, rank 0's on every rank."""
        vals = None
        if self._leader:
            p = self.planner.perf()
            vals = np.array([p[k] for k in _PLANNER_PERF_KEYS], np.int64)
        got = self._bcast([vals], [(len(_PLANNER_PERF_KEYS),)],
                          [np.int64])[0]
        return dict(zip(_PLANNER_PERF_KEYS, (int(v) for v in got)))

    def iter_time_us(self) -> int:
        """Rank 0's planning time, on every rank (JAX broadcasts it, so a
        rank's report never shows a follower's zero)."""
        v = np.array([self.planner.iter_time_us()], np.int64) \
            if self._leader else None
        return int(self._bcast([v], [(1,)], [np.int64])[0][0])

    def queue_length(self) -> int:
        if not self._leader:
            raise RuntimeError(
                "BroadcastPlanner.queue_length is rank 0's alone (the "
                "program queue lives there); gate the call on rank 0")
        return self.planner.queue_length()

    def close(self) -> None:
        if self.planner is not None:
            self.planner.close()


class BroadcastScheduler:
    """The scheduler `factory()` makes, on rank 0 of `comm`, with its
    assignments broadcast to every rank. `batch_size` is a rank's batch;
    the scheduler is made for `nrank = comm.size` workers."""

    def __init__(self, factory: Callable, comm, batch_size: int):
        self.comm = comm
        self.nrank, self.mbs = comm.size, batch_size
        self._leader = comm.rank == 0
        self.sched = factory() if self._leader else None
        if self._leader:
            # LookaheadScheduler narrows its batch on a tiny stream;
            # NativeScheduler names it mbs
            plans = (self.sched.nrank, getattr(self.sched, "batch_size",
                                               getattr(self.sched, "mbs",
                                                       None)))
            if plans != (self.nrank, batch_size):
                raise ValueError(
                    f"the scheduler plans {plans[0]} workers x {plans[1]} "
                    f"samples; the group needs {self.nrank} x "
                    f"{batch_size}")

    def _bcast(self, values: Optional[np.ndarray], n: int) -> np.ndarray:
        """Rank 0's `values` (int64 [n]) on every rank."""
        return broadcast_arrays(self.comm, [values], [(n,)], [np.int64])[0]

    def pop(self) -> Optional[Tuple[np.ndarray, List]]:
        """(assignment [S, B] int64, []) on every rank, or None on every
        rank at the end of the stream."""
        n = 1 + self.nrank * self.mbs
        vals = None
        if self._leader:
            vals = np.zeros(n, np.int64)
            r = self.sched.pop()
            if r is not None:
                vals[0] = 1
                vals[1:] = np.asarray(r[0], np.int64).reshape(-1)
        got = self._bcast(vals, n)
        if not got[0]:
            return None
        return got[1:].reshape(self.nrank, self.mbs), []

    def perf(self) -> dict:
        """The scheduler's four cache counters, rank 0's on every rank."""
        vals = None
        if self._leader:
            p = self.sched.perf()
            vals = np.array([p[k] for k in _PERF_KEYS], np.int64)
        got = self._bcast(vals, len(_PERF_KEYS))
        return dict(zip(_PERF_KEYS, (int(v) for v in got)))

    def iter_time_us(self) -> int:
        """Rank 0's planning time; 0 on the other ranks, as in JAX."""
        return self.sched.iter_time_us() if self._leader else 0

    def close(self) -> None:
        if self.sched is not None:
            self.sched.close()
