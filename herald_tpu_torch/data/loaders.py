"""Host-side batching (the port's own copy of `herald_tpu/data/loaders.py`).

Replaces the reference `python/hetu/dataloader.py` (ring-buffered host
batches with strided data-parallel sharding, `dataloader.py:26`) and the
Laia dataloader glue (`python/hetu/laia/laia_dataloader.py`).

The engine moves batches to the device (`Engine._batch_feed`); these
classes only produce numpy batches, one global batch per step, laid out
`[num_workers, per_worker_batch, ...]`.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np


class Dataloader:
    """Strided-shard minibatch iterator (reference Dataloader semantics).

    In the reference, each DP worker takes samples `rank, rank+nrank, ...`
    (`python/hetu/dataloader.py:26`). Here a single host process feeds all
    local devices, so `next_batch()` returns the full per-step global batch
    stacked as [nrank, batch_size, ...].
    """

    def __init__(self, arrays: Sequence[np.ndarray], batch_size: int,
                 nrank: int = 1, drop_last: bool = True):
        assert len({len(a) for a in arrays}) == 1, "arrays must align"
        self.arrays = [np.asarray(a) for a in arrays]
        self.batch_size = batch_size          # per-worker batch
        self.nrank = nrank
        self.drop_last = drop_last
        n = len(self.arrays[0])
        self.samples_per_worker = n // nrank
        if drop_last:
            self.batch_num = self.samples_per_worker // batch_size
        else:
            self.batch_num = int(np.ceil(self.samples_per_worker / batch_size))
        assert self.batch_num > 0, "not enough samples for one batch"
        self.batch_index = 0

    def _worker_indices(self, rank: int, batch_id: int) -> np.ndarray:
        start = batch_id * self.batch_size
        stop = min(start + self.batch_size, self.samples_per_worker)
        local = np.arange(start, stop)
        # strided shard: sample k of worker r is global row r + k*nrank
        idx = rank + local * self.nrank
        if len(idx) < self.batch_size:  # pad last batch by cycling
            if len(idx) == 0:
                idx = np.zeros(1, np.int64)
            idx = np.resize(idx, self.batch_size)   # repeats cyclically
        return idx

    def next_batch(self):
        b = self.batch_index
        self.batch_index = (self.batch_index + 1) % self.batch_num
        idx = np.stack([self._worker_indices(r, b) for r in range(self.nrank)])
        return [a[idx] for a in self.arrays]

    def __iter__(self) -> Iterator:
        for _ in range(self.batch_num):
            yield self.next_batch()


class LookaheadDataloader:
    """Scheduler-driven loader (reference LAIADataloader semantics).

    Every worker keeps the full dataset and indexes it by the lookahead
    scheduler's per-batch sample assignment; the sparse stream additionally
    carries the per-worker communication plan
    (`python/hetu/laia/laia_dataloader.py:202-213`).
    """

    def __init__(self, arrays: Sequence[np.ndarray], scheduler):
        self.arrays = [np.asarray(a) for a in arrays]
        self.sched = scheduler
        self.batch_num = scheduler.batch_num
        self.batch_size = scheduler.batch_size
        self.batch_index = 0

    def next_batch(self):
        """Return ([arr[assignment] for arrays], comm_plans).

        assignment: [nrank, batch_size] sample indices per worker.
        comm_plans: list of per-worker plan arrays (ragged; engine pads).
        """
        assign, plans = self.sched.get_batch(self.batch_index)
        self.batch_index = (self.batch_index + 1) % self.batch_num
        self.sched.step_forward()
        batches = [a[assign] for a in self.arrays]
        return batches, plans
