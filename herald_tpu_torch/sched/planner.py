"""Cache planner binding (the port's own copy of
`herald_tpu/sched/planner.py`): per-step cache micro-programs, padded to
static shapes for the device step.

The planner (csrc/herald_cache_planner.cc) merges the reference's Laia
scheduler and hetu_cache bookkeeping; see the C++ header comment for the
design contract. The port builds it from those sources itself
(`sched/build.py`) and binds it here with its own ctypes signatures. This
wrapper pads the ragged per-worker arrays to (U_cap, F_cap) with the
engine's positive out-of-bounds sentinel convention and stacks them
[nrank, cap]; the same ids give the same arrays as the JAX package's
binding.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from herald_tpu_torch.utils.profiler import span


@dataclasses.dataclass
class StepProgram:
    """One global batch's cache micro-program (already padded)."""
    assign: np.ndarray        # [nrank, mbs] sample indices
    slots: np.ndarray         # [nrank, U_cap] int32, cache slot per sorted
                              #   unique batch key; C (OOB) for padding
    pulls: np.ndarray         # [nrank, U_cap] bool, pull from owner
    flush_ids: np.ndarray     # [nrank, F_cap] int32, -1 padding (ids are
                              #   asserted < 2^31 by the engine)
    flush_slots: np.ndarray   # [nrank, F_cap] int32, C (OOB) padding
    prefetch_ids: np.ndarray = None    # [nrank, P_cap] int32, -1 padding:
                              #   rows hoisted EARLIER from later batches
                              #   (pull smoothing); fetched + inserted
                              #   this step, read by a later batch
    prefetch_slots: np.ndarray = None  # [nrank, P_cap] int32, C padding
    uniq: np.ndarray = None   # [nrank, U_cap] int32 sorted unique batch
                              #   keys, -1 padding (host-side dedup: the
                              #   device step's jnp.unique replacement)
    inv: np.ndarray = None    # [nrank, mbs*num_tables] int32, position ->
                              #   index into uniq (jnp.unique inverse)


class _PlannerLib:
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            from herald_tpu_torch.sched.build import planner_lib_path
            lib = ctypes.CDLL(planner_lib_path())
            i64p = ctypes.POINTER(ctypes.c_int64)
            i32p = ctypes.POINTER(ctypes.c_int32)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.hplan_create.restype = ctypes.c_void_p
            lib.hplan_create.argtypes = [
                i64p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int64]
            lib.hplan_phase_times.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_long)]
            lib.hplan_start.argtypes = [ctypes.c_void_p]
            lib.hplan_pop_padded.restype = ctypes.c_int
            lib.hplan_pop_padded.argtypes = [
                ctypes.c_void_p, i64p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, i32p, u8p, i32p, i32p,
                i32p, i32p, i32p, i32p]
            lib.hplan_pop_chunk_padded.restype = ctypes.c_int64
            lib.hplan_pop_chunk_padded.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, i64p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, i32p, u8p, i32p, i32p, i32p, i32p,
                i32p, i32p, ctypes.c_int64]
            lib.hplan_queue_length.restype = ctypes.c_int64
            lib.hplan_queue_length.argtypes = [ctypes.c_void_p]
            lib.hplan_perf.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_long)]
            lib.hplan_iter_time_us.restype = ctypes.c_long
            lib.hplan_iter_time_us.argtypes = [ctypes.c_void_p]
            lib.hplan_dirty_dump.restype = ctypes.c_int64
            lib.hplan_dirty_dump.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                             i64p, i32p]
            lib.hplan_destroy.argtypes = [ctypes.c_void_p]
            obj = super().__new__(cls)
            obj.lib = lib
            cls._inst = obj
        return cls._inst


class CachePlanner:
    def __init__(self, sparse_ids: np.ndarray, nrank: int, batch_size: int,
                 cache_rows: int, num_shards: int, rows_per_shard: int,
                 epochs: int = 1, flush_cap: Optional[int] = None,
                 owner_cap: Optional[int] = None, top_k: int = 0,
                 table_order: Optional[Sequence[int]] = None,
                 n_threads: int = 8, queue_cap: int = 16,
                 drop_last: bool = True, policy: str = "lru",
                 assign_mode: str = "affinity", pinned_rows: int = 0,
                 bound: int = 0, unique_cap: Optional[int] = None,
                 pull_target: int = 0, hoist_window: int = 0,
                 prefetch_cap: int = 0, shuffle_seed: int = 0):
        ids = np.ascontiguousarray(sparse_ids, np.int64)
        assert ids.ndim == 2
        n, num_tables = ids.shape
        self.nrank = nrank
        self.mbs = batch_size
        self.num_tables = num_tables
        # unique_cap below batch*tables is allowed (probe-sized padding,
        # HeraldConfig.sched_unique_slots); pop() raises if a batch's
        # actual uniques exceed it (jnp.unique would silently truncate)
        self.U_cap = int(unique_cap or batch_size * num_tables)
        # one batch's unique keys must fit: otherwise two same-batch keys
        # would share a slot and the forward pass reads wrong residents
        # (the reference has the same implicit requirement — its cache
        # limit of 10% of 33M rows vastly exceeds per-batch uniques)
        if cache_rows < self.U_cap:
            raise ValueError(
                f"cache_rows ({cache_rows}) must be >= per-worker batch "
                f"unique capacity ({self.U_cap} = batch {batch_size} x "
                f"{num_tables} tables)")
        self.F_cap = flush_cap or self.U_cap
        # flush_cap below U_cap is allowed (sizing from a measured probe
        # pass shrinks the padded flush arrays dramatically in the
        # big-cache regime where flushes are rare) — but mandatory flushes
        # (stale-refresh + eviction) are never deferred by the planner, so
        # pop() verifies every program fits and raises rather than
        # truncate (losing a flush would lose gradient deltas)
        if self.F_cap < 1:
            raise ValueError(f"flush_cap ({self.F_cap}) must be >= 1")
        # per-owner routing capacity for flushes must match the engine's
        # all-to-all bucket capacity
        self.owner_cap = owner_cap or self.F_cap
        self.cache_rows = cache_rows
        spw = n // nrank
        self.batch_num = (spw // batch_size if drop_last
                          else int(np.ceil(spw / batch_size)))
        # operating envelope (docs/OPERATIONS.md "Planner operating
        # envelope"): host planning cost on one CPU core, measured by the
        # JAX package's benchmarks/planner_scale.py at 7.5/13/47/134
        # ms/batch for 8/16/32/64 ranks (host code, the same in both
        # packages); an ONLINE planner keeps pace iff ms/batch /
        # min(cores, nrank) <= device step ms. Warn when configured
        # clearly outside it — the tape (sched/replay.py, CLI
        # --plan-cache) removes the cost entirely for fixed streams.
        if nrank >= 32:
            import os as _os
            import warnings as _warnings
            pts = {8: 7.5, 16: 13.0, 32: 47.0, 64: 134.0}
            ks = sorted(pts)
            est = pts.get(nrank) or np.interp(
                nrank, ks, [pts[k] for k in ks]) * max(1.0, nrank / 64)
            cores = _os.cpu_count() or 1
            per_core = est / max(min(cores, nrank), 1)
            if per_core > 2.0:   # > ~2x a 1 ms step: cannot keep pace
                _warnings.warn(
                    f"online planner at nrank={nrank} costs ~{est:.0f} "
                    f"ms/batch measured on one core (~{per_core:.0f} ms "
                    f"spread over {cores} cores) — outside the operating "
                    f"envelope for ~1 ms device steps. Record a plan "
                    f"tape (--plan-cache) or run the planner on a host "
                    f"with >= {int(est / 2) + 1} cores; see "
                    f"docs/OPERATIONS.md", UserWarning, stacklevel=2)
        self._lib = _PlannerLib().lib
        order_ptr = None
        if table_order is not None:
            self._order = np.ascontiguousarray(table_order, np.int32)
            order_ptr = self._order.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int))
        policy_id = {"lru": 0, "lfu": 1, "lfuopt": 2}[policy.lower()]
        # "roundrobin" = the reference's naive_scheduler baseline
        # (laia.pyx:163-189): strided sample placement, no affinity — for
        # A/Bing the scheduling gain with everything else held equal
        mode_id = {"affinity": 0, "roundrobin": 1}[assign_mode.lower()]
        # ids < pinned_rows form the replicated hot tier: no cache slot,
        # no pull/flush traffic (CachedEngine pinned_rows contract)
        self.pinned_rows = int(pinned_rows)
        # HET bounded staleness (reference --bound: a cached row is usable
        # until it missed more than `bound` remote updates,
        # ps-lite/src/PSFhandle_embedding.cc:30-64); 0 = always refresh
        self.bound = int(bound)
        # pull smoothing: when pull_target > 0 (with a window and a
        # prefetch cap), the planner hoists over-target pulls of batch n
        # into earlier underfull batches as prefetches, so the static
        # pull capacity can sit near the MEAN bucket size
        self.pull_target = int(pull_target)
        self.hoist_window = int(hoist_window)
        self.P_cap = int(prefetch_cap) if (pull_target and hoist_window
                                           and prefetch_cap) else 0
        self._h = self._lib.hplan_create(
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, num_tables, nrank, batch_size, self.batch_num, epochs,
            cache_rows, self.F_cap, self.owner_cap, num_shards,
            rows_per_shard, top_k, order_ptr, n_threads, queue_cap,
            policy_id, mode_id, self.pinned_rows, self.bound,
            self.pull_target, self.hoist_window, self.P_cap,
            int(shuffle_seed))
        if not self._h:
            raise ValueError(
                "native cache planner rejected the configuration "
                "(see stderr; commonly: an id exceeds the table rows)")
        self._ids_keepalive = ids
        self._lib.hplan_start(self._h)

    def pop_into(self, assign, slots, pulls, flush_ids, flush_slots,
                 prefetch_ids=None, prefetch_slots=None, uniq=None,
                 inv=None) -> bool:
        """Pop one program directly into caller-provided PADDED buffers
        (device layout: assign [nrank*mbs] i64, slots/pulls [nrank*U_cap]
        i32/u8, flush rows [nrank*F_cap] i32, prefetch rows
        [nrank*max(P_cap,1)] i32, uniq [nrank*U_cap] i32, inv
        [nrank*mbs*num_tables] i32). Returns False at end of stream;
        raises if a program exceeds the static caps (truncating would
        corrupt training). One C call per step — the pad-and-stack Python
        path cost as much as the device step at single-chip scale.
        """
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        P = max(self.P_cap, 1)
        if prefetch_ids is None:
            prefetch_ids = np.empty(self.nrank * P, np.int32)
            prefetch_slots = np.empty(self.nrank * P, np.int32)
        if uniq is None:
            uniq = np.empty(self.nrank * self.U_cap, np.int32)
            inv = np.empty(self.nrank * self.mbs * self.num_tables,
                           np.int32)
        rc = self._lib.hplan_pop_padded(
            self._h, assign.ctypes.data_as(i64p), self.U_cap, self.F_cap,
            P, self.cache_rows,
            slots.ctypes.data_as(i32p), pulls.ctypes.data_as(u8p),
            flush_ids.ctypes.data_as(i32p),
            flush_slots.ctypes.data_as(i32p),
            prefetch_ids.ctypes.data_as(i32p),
            prefetch_slots.ctypes.data_as(i32p),
            uniq.ctypes.data_as(i32p), inv.ctypes.data_as(i32p))
        if rc == -2:
            raise RuntimeError(
                f"a program exceeds the static caps (unique_cap "
                f"{self.U_cap} / flush_cap {self.F_cap} / prefetch_cap "
                f"{P}); size them from a probe pass (sched/sizing.py) or "
                f"leave the defaults")
        return rc == 0

    def pop_chunk(self, steps: int):
        """Pop up to `steps` programs into freshly-allocated stacked
        device-layout buffers — ONE C call (hplan_pop_chunk_padded),
        which blocks on the producer inside C instead of bouncing a
        Python/ctypes/condvar round trip per step. Returns (K, assign,
        slots, pulls, flush_ids, flush_slots, prefetch_ids,
        prefetch_slots, uniq, inv) with K <= steps actually filled (0 at
        end of stream; rows beyond K are uninitialized). Under a profiler,
        the span `planner.pop` (`utils/profiler.py`)."""
        with span("planner.pop") as sp:
            if sp:
                sp.counts["queue_before"] = self.queue_length()
            nr = self.nrank
            P = max(self.P_cap, 1)
            assign = np.empty((steps, nr * self.mbs), np.int64)
            slots = np.empty((steps, nr * self.U_cap), np.int32)
            pulls = np.empty((steps, nr * self.U_cap), np.uint8)
            fids = np.empty((steps, nr * self.F_cap), np.int32)
            fslots = np.empty((steps, nr * self.F_cap), np.int32)
            pf_ids = np.empty((steps, nr * P), np.int32)
            pf_slots = np.empty((steps, nr * P), np.int32)
            inv_row = nr * self.mbs * self.num_tables
            uniq = np.empty((steps, nr * self.U_cap), np.int32)
            inv = np.empty((steps, inv_row), np.int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            i32p = ctypes.POINTER(ctypes.c_int32)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            K = int(self._lib.hplan_pop_chunk_padded(
                self._h, steps, nr * self.mbs,
                assign.ctypes.data_as(i64p), self.U_cap, self.F_cap, P,
                self.cache_rows, slots.ctypes.data_as(i32p),
                pulls.ctypes.data_as(u8p), fids.ctypes.data_as(i32p),
                fslots.ctypes.data_as(i32p), pf_ids.ctypes.data_as(i32p),
                pf_slots.ctypes.data_as(i32p), uniq.ctypes.data_as(i32p),
                inv.ctypes.data_as(i32p), inv_row))
            if K == -2:
                raise RuntimeError(
                    f"a program exceeds the static caps (unique_cap "
                    f"{self.U_cap} / flush_cap {self.F_cap} / prefetch_cap "
                    f"{P}); size them from a probe pass (sched/sizing.py) or "
                    f"leave the defaults")
            if sp:
                sp.counts.update(K=K, plan_us=sum(
                    self.phase_times_us().values()))
        return (K, assign, slots, pulls, fids, fslots, pf_ids, pf_slots,
                uniq, inv)

    def pop(self) -> Optional[StepProgram]:
        assign = np.empty(self.nrank * self.mbs, np.int64)
        slots = np.empty(self.nrank * self.U_cap, np.int32)
        pulls = np.empty(self.nrank * self.U_cap, np.uint8)
        flush_ids = np.empty(self.nrank * self.F_cap, np.int32)
        flush_slots = np.empty(self.nrank * self.F_cap, np.int32)
        P = max(self.P_cap, 1)
        pf_ids = np.empty(self.nrank * P, np.int32)
        pf_slots = np.empty(self.nrank * P, np.int32)
        uniq = np.empty(self.nrank * self.U_cap, np.int32)
        inv = np.empty(self.nrank * self.mbs * self.num_tables, np.int32)
        if not self.pop_into(assign, slots, pulls, flush_ids, flush_slots,
                             pf_ids, pf_slots, uniq, inv):
            return None
        nr = self.nrank
        return StepProgram(assign=assign.reshape(nr, self.mbs),
                           slots=slots.reshape(nr, self.U_cap),
                           pulls=pulls.reshape(nr, self.U_cap)
                           .astype(bool),
                           flush_ids=flush_ids.reshape(nr, self.F_cap),
                           flush_slots=flush_slots.reshape(nr, self.F_cap),
                           prefetch_ids=pf_ids.reshape(nr, P),
                           prefetch_slots=pf_slots.reshape(nr, P),
                           uniq=uniq.reshape(nr, self.U_cap),
                           inv=inv.reshape(nr, -1))

    def fast_forward(self, k: int) -> int:
        """Advance the program stream past the first `k` batches.

        Mid-epoch resume: planning is deterministic given (ids, config),
        so a restarted run recreates the planner and discards the
        programs the crashed run already executed — the cache simulator
        replays to the exact state the checkpointed device cache arrays
        are in (CachedTrainState checkpoints cache_data/cache_delta).
        Replaces the reference's Van-level recovery story
        (ps-lite/src/van.cc:104-116) with checkpoint + replay.
        Returns the number of batches actually skipped.
        """
        assign = np.empty(self.nrank * self.mbs, np.int64)
        slots = np.empty(self.nrank * self.U_cap, np.int32)
        pulls = np.empty(self.nrank * self.U_cap, np.uint8)
        fids = np.empty(self.nrank * self.F_cap, np.int32)
        fslots = np.empty(self.nrank * self.F_cap, np.int32)
        P = max(self.P_cap, 1)
        pfi = np.empty(self.nrank * P, np.int32)
        pfs = np.empty(self.nrank * P, np.int32)
        uniq = np.empty(self.nrank * self.U_cap, np.int32)
        inv = np.empty(self.nrank * self.mbs * self.num_tables, np.int32)
        done = 0
        while done < k and self.pop_into(assign, slots, pulls, fids,
                                         fslots, pfi, pfs, uniq, inv):
            done += 1
        return done

    def queue_length(self) -> int:
        return int(self._lib.hplan_queue_length(self._h))

    def perf(self) -> dict:
        out = (ctypes.c_long * 6)()
        self._lib.hplan_perf(self._h, out)
        return {"miss_pull": out[0], "miss_push": out[1],
                "update_pull": out[2], "update_push": out[3],
                "deferred_flush": out[4], "hoisted_pull": out[5]}

    def iter_time_us(self) -> int:
        return int(self._lib.hplan_iter_time_us(self._h))

    def phase_times_us(self) -> dict:
        """Cumulative planning time per phase (planner self-profiling)."""
        out = (ctypes.c_long * 4)()
        self._lib.hplan_phase_times(self._h, out)
        return {"score": out[0], "assign": out[1],
                "plan": out[2], "stale": out[3]}

    def dirty_rows(self, worker: int):
        """Residual dirty (id, slot) pairs for the final sync/flush.

        Only valid after the planning thread finished (every micro-program
        popped AND executed): the planner runs up to queue_cap batches
        ahead of the device, so an early dump would name (key, slot) pairs
        for batches the device never ran and corrupt the owner table."""
        n = self._lib.hplan_dirty_dump(self._h, worker, None, None)
        if n < 0 or self.queue_length() > 0:
            raise RuntimeError(
                "dirty_rows/sync called while the planner is still "
                "producing or programs remain unconsumed: drain the "
                "program stream (pop until None) before the final sync, "
                "or drop the planner without syncing")
        ids = np.empty(max(int(n), 1), np.int64)
        slots = np.empty(max(int(n), 1), np.int32)
        if n > 0:
            self._lib.hplan_dirty_dump(
                self._h, worker,
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return ids[:n], slots[:n]

    def close(self):
        if getattr(self, "_h", None):
            self._lib.hplan_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
