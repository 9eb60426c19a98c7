"""One lookahead scheduler for a group of ranks (port of
`herald_tpu/sched/service.py`, its `BroadcastScheduler`).

Assign-only mode over S ranks plans each global batch once: rank 0 alone
runs the native scheduler (csrc/herald_sched.cc, `sched/scheduler.py`)
for `nrank = S` workers, and every pop broadcasts its assignment to every
rank through the group's `Comm.broadcast_` (`parallel/comm.py`). The
comm plans stay on rank 0: assign-only training reads the assignment
alone. Every pop, `perf` and `close` is a collective or ends one, so
every rank calls them the same number of times, in one order.

The broadcast moves one int64 buffer a pop, `[ok, assign[S, B]...]`: on
the card under NCCL (which moves only CUDA tensors), on the host under
gloo; one copy back to the host a pop either way.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

_PERF_KEYS = ("miss_pull", "miss_push", "update_pull", "update_push")


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
        dev = comm.device if comm.backend == "nccl" else torch.device("cpu")
        self._buf = torch.zeros(1 + self.nrank * batch_size,
                                dtype=torch.int64, device=dev)

    def _bcast(self, values: Optional[np.ndarray], n: int) -> np.ndarray:
        """Rank 0's `values` (int64 [n]) on every rank."""
        buf = self._buf[:n]
        if self._leader:
            buf.copy_(torch.from_numpy(values))
        self.comm.broadcast_([buf])
        # a copy of its own: the next pop reuses the buffer
        return buf.cpu().numpy().copy()

    def pop(self) -> Optional[Tuple[np.ndarray, List]]:
        """(assignment [S, B] int64, []) on every rank, or None on every
        rank at the end of the stream."""
        vals = None
        if self._leader:
            vals = np.zeros(self._buf.numel(), np.int64)
            r = self.sched.pop()
            if r is not None:
                vals[0] = 1
                vals[1:] = np.asarray(r[0], np.int64).reshape(-1)
        got = self._bcast(vals, self._buf.numel())
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
