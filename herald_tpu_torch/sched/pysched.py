"""Pure-numpy reference implementation of the lookahead scheduler (the
port's own copy of `herald_tpu/sched/pysched.py`).

Semantics-identical mirror of csrc/herald_sched.cc (same role as the
reference's Cython prototype `python/hetu/laia/laia.pyx` next to the C++
module): the tests hold the native scheduler to it.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np


class PyLruSim:
    """LRU simulator with validity bits (mirror of LruSim / the reference
    MiniLRUCache, `laia/include/mini_lru_cache.h:54-136`)."""

    def __init__(self, capacity: int, key_space: int):
        self.cap = capacity
        self.od = OrderedDict()      # key -> valid(bool); front = MRU end
        self.bitmap = np.zeros(key_space, dtype=bool)

    def check(self, key) -> bool:
        return bool(self.bitmap[key])

    def get(self, key) -> int:
        if key in self.od:
            res = -1 if self.od[key] else -2
            self.od.move_to_end(key)
            self.od[key] = True
            self.bitmap[key] = True
            return res
        return self.insert(key)

    def insert(self, key) -> int:
        self.od[key] = True
        self.od.move_to_end(key)
        self.bitmap[key] = True
        if len(self.od) > self.cap:
            victim, was_valid = next(iter(self.od.items()))
            del self.od[victim]
            self.bitmap[victim] = False
            return 1 if was_valid else 0
        return 0

    def outdate(self, key):
        if key in self.od:
            self.od[key] = False
            self.bitmap[key] = False

    def valid_keys(self):
        return sorted(k for k, v in self.od.items() if v)


class PyScheduler:
    """Batch-at-a-time mirror of herald::Scheduler (synchronous)."""

    def __init__(self, sparse_ids: np.ndarray, nrank: int, batch_size: int,
                 cache_size: int, top_k: int = 0,
                 table_order: Optional[Sequence[int]] = None):
        self.ids = np.asarray(sparse_ids, np.int64)
        self.n, self.num_tables = self.ids.shape
        self.nrank = nrank
        self.mbs = batch_size
        key_space = int(self.ids.max()) + 1
        self.caches = [PyLruSim(cache_size, key_space)
                       for _ in range(nrank)]
        self.top_k = top_k if top_k > 0 else self.num_tables
        self.top_k = min(self.top_k, self.num_tables)
        if table_order is None:
            sample_n = min(self.n, 200000)
            reuse = []
            for t in range(self.num_tables):
                col = self.ids[:sample_n, t]
                reuse.append(1.0 - len(np.unique(col)) / sample_n)
            table_order = np.argsort(-np.asarray(reuse), kind="stable")
        self.order = list(table_order)[: self.top_k]
        self.counters = dict(miss_pull=np.zeros(nrank, np.int64),
                             miss_push=np.zeros(nrank, np.int64),
                             update_pull=np.zeros(nrank, np.int64),
                             update_push=np.zeros(nrank, np.int64))
        self._batch = 0

    # ------------------------------------------------------------------
    def plan_next(self) -> Tuple[np.ndarray, List[np.ndarray]]:
        gbs = self.nrank * self.mbs
        start = self._batch * gbs
        self._batch += 1
        sample_idx = (start + np.arange(gbs)) % self.n

        # score
        scores = np.zeros((gbs, self.nrank), np.int64)
        for i, si in enumerate(sample_idx):
            for k in self.order:
                key = self.ids[si, k]
                for z in range(self.nrank):
                    scores[i, z] += self.caches[z].check(key)

        # greedy assignment, descending best score
        best = scores.max(axis=1)
        order_idx = np.argsort(-best, kind="stable")
        load = [0] * self.nrank
        assign = np.zeros((self.nrank, self.mbs), np.int64)
        for i in order_idx:
            row = scores[i]
            pick, pick_score = -1, -1
            for z in range(self.nrank):
                if load[z] < self.mbs and row[z] > pick_score:
                    pick, pick_score = z, row[z]
            assign[pick, load[pick]] = sample_idx[i]
            load[pick] += 1

        # comm plans: keys other workers need that are valid on worker z
        plans = []
        for z in range(self.nrank):
            keys = set()
            for w in range(self.nrank):
                if w == z:
                    continue
                for j in range(self.mbs):
                    for key in self.ids[assign[w, j]]:
                        if self.caches[z].check(key):
                            keys.add(int(key))
            plans.append(np.array(sorted(keys), np.int64))

        # replay
        for z in range(self.nrank):
            for k in plans[z]:
                self.caches[z].outdate(int(k))
            uniq = np.unique(self.ids[assign[z]])
            for k in uniq:
                res = self.caches[z].get(int(k))
                if res < 0:
                    if res == -2:
                        self.counters["update_pull"][z] += 1
                else:
                    self.counters["miss_pull"][z] += 1
                    if res > 0:
                        self.counters["miss_push"][z] += 1
            self.counters["update_push"][z] += len(plans[z])
        return assign, plans

    def perf(self):
        return {k: int(v.sum() // self.nrank)
                for k, v in self.counters.items()}
