"""Lookahead scheduler: ctypes binding + prefetch window (the port's own
copy of `herald_tpu/sched/scheduler.py`).

Python half of the Herald core. Binds the native scheduler
(csrc/herald_sched.cc, built from the checkout's sources by the port's
loader, `sched/build.py`) and reproduces the reference consumer protocol
(`python/hetu/laia/laia_dataloader.py`):

- a `queue_size`-deep window of (assignment, comm_plan) pairs;
- **one-batch lookahead**: the first comm plan is discarded so
  `comm_plan[i]` is the plan of batch i+1 — the plan a worker needs while
  training batch i tells it what to flush *before* batch i+1's reads
  (`laia_dataloader.py:107-114`);
- `step_forward` advances the window without blocking when the planner is
  behind (`laia_dataloader.py:152-169`).
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


class _NativeLib:
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            from herald_tpu_torch.sched.build import sched_lib_path
            lib = ctypes.CDLL(sched_lib_path())
            lib.hsched_create.restype = ctypes.c_void_p
            lib.hsched_create.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int]
            lib.hsched_start.argtypes = [ctypes.c_void_p]
            lib.hsched_pop_begin.restype = ctypes.c_int64
            lib.hsched_pop_begin.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64)]
            lib.hsched_pop_finish.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
            lib.hsched_queue_length.restype = ctypes.c_int64
            lib.hsched_queue_length.argtypes = [ctypes.c_void_p]
            lib.hsched_perf.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_long)]
            lib.hsched_iter_time_us.restype = ctypes.c_long
            lib.hsched_iter_time_us.argtypes = [ctypes.c_void_p]
            lib.hsched_phase_times.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_long)]
            lib.hsched_destroy.argtypes = [ctypes.c_void_p]
            obj = super().__new__(cls)
            obj.lib = lib
            cls._inst = obj
        return cls._inst


class NativeScheduler:
    """Thin handle over the C++ planner."""

    def __init__(self, sparse_ids: np.ndarray, nrank: int, batch_size: int,
                 batch_num: int, epochs: int, cache_size: int,
                 top_k: int = 0, table_order: Optional[Sequence[int]] = None,
                 n_threads: Optional[int] = None, queue_cap: int = 16):
        if n_threads is None:
            # pool threads beyond the physical cores only add switching
            # overhead (phases are CPU-bound)
            n_threads = min(16, os.cpu_count() or 1)
        self._lib = _NativeLib().lib
        ids = np.ascontiguousarray(sparse_ids, dtype=np.int64)
        assert ids.ndim == 2
        self.nrank = nrank
        self.mbs = batch_size
        order_ptr = None
        if table_order is not None:
            order_arr = np.ascontiguousarray(table_order, dtype=np.int32)
            order_ptr = order_arr.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int))
        self._h = self._lib.hsched_create(
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ids.shape[0], ids.shape[1], nrank, batch_size, batch_num,
            epochs, cache_size, top_k, order_ptr, n_threads, queue_cap)
        if not self._h:
            raise ValueError(
                f"native scheduler rejected the configuration "
                f"(nrank={nrank}; at most 64 workers are supported)")
        self._ids_keepalive = ids
        self._started = False

    def start(self):
        self._lib.hsched_start(self._h)
        self._started = True

    def pop(self) -> Optional[Tuple[np.ndarray, List[np.ndarray]]]:
        """Blocking: next (assignment [nrank, mbs], plans list-of-arrays)."""
        assign = np.empty(self.nrank * self.mbs, np.int64)
        sizes = np.empty(self.nrank, np.int64)
        total = self._lib.hsched_pop_begin(
            self._h, assign.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if total < 0:
            return None
        plans_flat = np.empty(max(int(total), 1), np.int64)
        self._lib.hsched_pop_finish(
            self._h,
            plans_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        plans, off = [], 0
        for z in range(self.nrank):
            n = int(sizes[z])
            plans.append(plans_flat[off:off + n].copy())
            off += n
        return assign.reshape(self.nrank, self.mbs), plans

    def queue_length(self) -> int:
        return int(self._lib.hsched_queue_length(self._h))

    def perf(self) -> dict:
        out = (ctypes.c_long * 4)()
        self._lib.hsched_perf(self._h, out)
        return {"miss_pull": out[0], "miss_push": out[1],
                "update_pull": out[2], "update_push": out[3]}

    def iter_time_us(self) -> int:
        return int(self._lib.hsched_iter_time_us(self._h))

    def phase_times_us(self) -> dict:
        """Cumulative planning time per phase (scheduler self-profiling,
        the reference's `report_iter_time` with a per-phase breakdown)."""
        out = (ctypes.c_long * 4)()
        self._lib.hsched_phase_times(self._h, out)
        return {"score": out[0], "assign": out[1],
                "plan": out[2], "replay": out[3]}

    def close(self):
        if self._h:
            self._lib.hsched_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class LookaheadScheduler:
    """Prefetch-window consumer over the native planner.

    Drop-in role of the reference `LAIAScheduler`
    (`laia_dataloader.py:29-169`); `get_batch(i)` returns (assignment,
    plans-of-batch-i+1) and `step_forward()` advances the window.
    """

    def __init__(self, sparse_ids: np.ndarray, nrank: int, batch_size: int,
                 cache_size: int, epochs: int = 1, queue_size: int = 5,
                 top_k: int = 0, table_order=None, n_threads: int = 8,
                 drop_last: bool = True):
        n = len(sparse_ids)
        self.samples_per_worker = n // nrank
        # keep the REQUESTED batch size (the CLI's compiled step shapes
        # depend on it) and narrow the window on tiny streams instead
        self.batch_size = min(batch_size, max(1, self.samples_per_worker))
        self.batch_num = (self.samples_per_worker // self.batch_size
                          if drop_last else int(np.ceil(
                              self.samples_per_worker / self.batch_size)))
        self.nrank = nrank
        self.epochs = epochs
        self.queue_size = min(queue_size, self.batch_num)
        self.native = NativeScheduler(
            sparse_ids, nrank, self.batch_size, self.batch_num, epochs,
            cache_size, top_k=top_k, table_order=table_order,
            n_threads=n_threads)
        self.native.start()

        self._window: List = []
        self._arr_map = {}
        self._closed = False
        # one-batch lookahead: discard the very first plan so plan slot i
        # holds the plan of batch i+1
        first = self.native.pop()
        assert first is not None
        self._pending_assign = first[0]
        for i in range(self.queue_size):
            nxt = self.native.pop()
            if nxt is None:
                self._closed = True
                nxt = (self._pending_assign, [np.empty(0, np.int64)
                                              for _ in range(nrank)])
            self._window.append((self._pending_assign, nxt[1]))
            self._pending_assign = nxt[0]
            self._arr_map[i] = i
        self._step = 0
        self._min_served = 0

    def get_batch(self, batch_id: int):
        idx = self._arr_map[batch_id % self.batch_num]
        return self._window[idx]

    def step_forward(self):
        self._step += 1
        while self._min_served < self._step:
            if self._closed or (
                    self.native.queue_length() < 2
                    and self._step - self._min_served < self.queue_size):
                break
            nxt = self.native.pop()
            if nxt is None:
                self._closed = True
                break
            min_batch = self._min_served % self.batch_num
            slot = self._arr_map.pop(min_batch)
            self._window[slot] = (self._pending_assign, nxt[1])
            self._pending_assign = nxt[0]
            new_batch = (min_batch + self.queue_size) % self.batch_num
            self._arr_map[new_batch] = slot
            self._min_served += 1

    def pop(self):
        """Sequential-consumer facade over the window (the CLI's
        assign-only loop and the reference's training loop both walk
        batches in order): returns (assignment [nrank, mbs],
        plans-of-next-batch) and advances the window; None at end of
        stream. get_batch/step_forward remain for random-access
        consumers."""
        if self._step >= self.batch_num * self.epochs:
            return None
        out = self.get_batch(self._step % self.batch_num)
        self.step_forward()
        return out

    def iter_time_us(self) -> int:
        return self.native.iter_time_us()

    def perf(self):
        return self.native.perf()

    def close(self):
        self.native.close()
