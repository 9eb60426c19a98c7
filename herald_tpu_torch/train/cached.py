"""Cached training engine: hot-row cache + planned flush/refresh (port of
`herald_tpu/train/cached.py`).

State adds two arrays to the base engine:

    cache [C, 2W] f32: columns [0,W) = cached row values (locally updated,
    quantized through table_dtype), columns [W,2W) = accumulated unflushed
    gradient deltas

and the pinned hot tier (`hot_table` [P, W] in the table dtype, its f32
optimizer slots). Each step executes the planner's micro-program
(`herald_tpu_torch/sched/planner.py`) in JAX's phase order:

    1. FLUSH   apply dirty deltas to the owner table with the embedding
               optimizer, zero the flushed deltas
    2. PULL    read missed/stale rows, plus prefetches hoisted from later
               batches, from the *updated* table
    3. INSERT  write prefetched rows into their cache slots
    4. FORWARD dense tower on pulled-or-resident rows (plus the pinned
               tier's rows)
    5. UPDATE  one cache write per batch key: forward value - lr*grad,
               plus delta accumulation; the pinned tier takes exact SGD

Kernels on the step: K1 (`embedding_gather`) reads the pull from the
table, the [U_cap, 2W] cache-slot rows and the flush's cache and table
rows; K3 (`hot_onehot_push`) sums the per-key gradients and, with a pinned
tier, the hot block's delta; K4's add form (`hot_onehot_gather_add_`)
adds the pinned tier's rows into the step's f32 rows in place. Every
other write is a scatter-*set* (XLA's `.at[].set(mode="drop")` in JAX,
outside any Pallas kernel), here `index_copy_`.

No host wait inside a step, and every shape fixed. Every sentinel of a
program (slot C for padding and pinned keys, id -1 for empty flush and
prefetch entries) is known on the host in the popped arrays, so staging
a chunk writes, per step, each write's targets and source positions as
lists of a fixed length (F_cap, P_cap, U_cap): a dropped entry repeats a
kept entry's target and position, so `index_copy_`'s duplicates write
the same bytes and a dropped entry changes nothing. Reads of sentinel
positions return zero rows through K1's and K4's bounds checks. The
state keeps JAX's shapes, so checkpoints interchange.

A chunk ships to the card in one copy from pinned host memory, one step
a row (`_stage_chunk`), and on a card each step replays a CUDA graph
(`train/graphs.py`) after one copy of its row. Under `sched_packed_wire`
on one device the row narrows as JAX's packed wire does: `inv` travels
as int16 when `U_cap` fits it, and an index row that assigns samples in
stream order travels as its base (`[K, 1]`); the step widens both on the
card, bit for bit. With `sched_chunk_memo` a chunk whose packed bytes and
steps equal a recently staged one's reuses that staged chunk and ships
nothing (`_memo_stage`, JAX's staged-chunk memo). A step runs the phases
and writes its program has work for: its variant (`StagedChunk.steps`)
picks the graph. A phase without work is a no-op in JAX too, which runs
it on its sentinels when `sched_noflush_variant` / `sched_nopull_variant`
is off; `noflush_chunks` / `nopull_chunks` count chunks with JAX's
per-chunk meaning of those flags.

Over S ranks (`comm_mode="hybrid"`, JAX's `num_shards > 1` branches) the
table is row-sharded as the plain hybrid engine's is (`train/engine.py`),
one planner plans for S workers (`make_planner`, on rank 0 through
`sched.service.BroadcastPlanner`), and rank r runs worker r's columns of
each broadcast chunk with a [C, 2W] cache of its own:
- the flush routes the flushed ids to their owners (`route_ids` over the
  F_cap-wide `flush_exchange`), sends the deltas there in the wire dtype
  (`scatter_grads`: f32, bf16 or int8 with per-row scales; the int8 wire
  leaves the exact residual `delta - q*scale` in the delta plane), and
  the owner reads its rows through K1, applies the embedding optimizer
  and writes them back with `engine.write_rows` (its targets exist only
  after the exchange, so no host list serves it);
- the pull routes the pull and prefetch ids through the engine's exchange
  (`gather_rows`: the owner's K1 read, the return all-to-all, a K1 read
  of the returned buffer by position, widened to f32);
- the loss is scaled by 1/S, and the dense grads, the loss and the
  overflow of both exchanges are summed in one all-reduce
  (`Engine._reduce`, with its dense-sync relaxation);
- the pinned tier holds the logical rows [0, P) (P rounded up to a
  multiple of S) on every rank; K3 sums the hot delta [P, W], a
  reduce-scatter gives rank r its block [r*P/S, (r+1)*P/S), the optimizer
  moves that block with the rank's slots, and an all-gather brings the
  new rows back, so the block stays identical on every rank.
Both exchanges are collectives, so whether a step flushes or pulls is
decided from every worker's columns of the chunk, the same on every rank;
the cache writes stay per rank. The steps run uncaptured.

The port packs a chunk into one copy whatever `sched_packed_wire` says,
where JAX's unpacked wire ships one array at a time; with the flag off
the memo is never consulted, as in JAX (`memo_hits` stays 0 while
`_memo_on` holds the flag). Over S ranks the row does not narrow.

Not ported: residency tracking and `serve_overlay` over S ranks, which
raise: they read every worker's cache, which JAX's launcher allows in
one process only (herald_tpu/launch/cli.py:850-854), and every
multi-rank run of the port is multi-process.
"""

from __future__ import annotations

import threading
import warnings
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from herald_tpu_torch.config import HeraldConfig
from herald_tpu_torch.models.base import ModelDef, get_model
from herald_tpu_torch.ops.kernels import (embedding_gather,
                                          hot_onehot_gather_add_,
                                          hot_onehot_push)
from herald_tpu_torch.parallel.exchange import (gather_rows, make_exchange,
                                                route_ids, rowquant_int8,
                                                scatter_grads)
from herald_tpu_torch.sched.planner import CachePlanner
from herald_tpu_torch.train.engine import (Engine, TrainState, refuse_bags,
                                          write_rows)
from herald_tpu_torch.train.graphs import (TORCH_DTYPES, Layout, layout_of,
                                           unpack)
from herald_tpu_torch.utils.profiler import span, spanned


class CachedTrainState(NamedTuple):
    """JAX's `CachedTrainState`: the same fields, in the same order."""
    table: torch.Tensor
    table_slots: Dict[str, torch.Tensor]
    dense: Dict[str, torch.Tensor]
    dense_slots: Dict[str, Dict[str, torch.Tensor]]
    step: torch.Tensor
    cache: torch.Tensor                  # [C, 2W] f32: values | deltas
    hot_table: torch.Tensor              # [P, W] table dtype ([1, W] if off)
    hot_slots: Dict[str, torch.Tensor]   # each [max(P, 1), W] f32


class StagedChunk(NamedTuple):
    """One chunk of programs on the device (`_stage_chunk`).

    `variant` is JAX's per-chunk dispatch (0 full, 1 flush-free, 2
    pull-free), for its counters. `steps[k]` is step k's variant, which of
    its writes and phases have work: (flush -> table "ft", flush -> cache
    "fc", pull, prefetch insert "pf", update "up"); the flush phase runs
    when "ft" or "fc" does. Over S ranks the flush and the pull flags say
    whether any worker flushes or pulls in the step (the exchanges are
    collectives), and the table's write has no host list. `packed` is a
    uint8 [K, nbytes] device tensor, step k's inputs in row k as `layout`
    places them (`train/graphs.py`): "d"/"y" (direct feed) or "idx"
    (index feed), "slots", "inv", "pull_ids", "fids", "fslots", "uniq"
    with a pinned tier, and each write's "<w>_tgt" (int64) and "<w>_pos"
    (int32) of a fixed length."""
    K: int
    variant: int
    index_feed: bool
    steps: tuple
    packed: torch.Tensor
    layout: Layout


WRITES = ("ft", "fc", "pf", "up")


def write_lists(mask: np.ndarray, target: np.ndarray):
    """[K, L] kept mask and targets -> (targets int64 [K, L], source
    positions int32 [K, L], any kept [K]): a dropped entry takes a kept
    entry's target and position, the dropped entries of a step spread
    over its kept ones in turn (thousands of writes to one row serialize
    on the card). A step that keeps nothing gets zeros, and its variant
    skips the write."""
    K, L = mask.shape
    n = mask.sum(axis=1)
    if L == 0:
        return (np.zeros((K, 0), np.int64), np.zeros((K, 0), np.int32),
                n > 0)
    # each step's kept positions first, in order
    order = np.argsort(~mask, axis=1, kind="stable")
    turn = np.arange(L)[None, :] % np.maximum(n, 1)[:, None]
    pos = np.where(mask, np.arange(L), np.take_along_axis(order, turn,
                                                          axis=1))
    tgt = np.take_along_axis(np.asarray(target), pos, axis=1).astype(np.int64)
    tgt[n == 0] = 0
    pos[n == 0] = 0
    return tgt, pos.astype(np.int32), n > 0


def _same_bytes(a: np.ndarray, b: np.ndarray) -> bool:
    """Whether two uint8 arrays hold the same bytes, compared 8 at a time
    where their length allows (half the time of a byte-wise compare)."""
    if a.size != b.size:
        return False
    if a.size % 8 == 0:
        a, b = a.view(np.uint64), b.view(np.uint64)
    return bool(np.array_equal(a, b))


class CachedEngine(Engine):
    """Engine variant executing planner micro-programs."""

    def __init__(self, cfg: HeraldConfig, model: Optional[ModelDef] = None,
                 table_rows: Optional[int] = None, device=None,
                 cuda_graphs: bool = True):
        refuse_bags(model or get_model(cfg.model), "the cached engine")
        cfg.use_cache = True
        super().__init__(cfg, model=model, table_rows=table_rows,
                         device=device, cuda_graphs=cuda_graphs)
        S = self.num_shards
        self.cache_rows = cfg.cache_rows(self.num_rows)
        self.pinned_rows = int(cfg.pinned_rows or 0)
        if self.pinned_rows and S > 1:
            # the hot tier reduce-scatters its grads into S blocks: round
            # up (the extra rows only widen the replicated tier)
            self.pinned_rows = -(-self.pinned_rows // S) * S
        assert self.pinned_rows <= self.num_rows
        # program arrays travel as int32; larger tables would wrap ids
        assert self.num_rows < 2**31, \
            f"table rows {self.num_rows} exceed int32 program ids"
        self._unsynced = False
        self._slot2id = None        # host residency mirror (serve views)
        self.noflush_chunks = 0     # chunks that took the flush-free path
        self.nopull_chunks = 0      # chunks that also took the pull-free path
        # the staged-chunk memo (sched_chunk_memo, `_memo_stage`): recent
        # staged chunks by content, {key: (host bytes, StagedChunk)}
        self._chunk_memo = OrderedDict()
        self._memo_bytes = 0
        self._memo_evicted = 0      # bytes evicted or replaced before a hit
        self._memo_on = bool(cfg.sched_chunk_memo)
        self._memo_lock = threading.Lock()  # _Prestager stages from a pool
        self.memo_hits = 0          # chunks whose copy was skipped
        self.U_cap = int(cfg.sched_unique_slots or self.ids_per_worker)
        self.F_cap = int(cfg.sched_flush_slots or self.U_cap)
        # prefetch arrays exist only when the planner will hoist: the same
        # three-way gate as CachePlanner (target AND window AND cap)
        self.P_cap = (int(cfg.sched_prefetch_slots or 128)
                      if (cfg.sched_pull_target and cfg.sched_hoist_window
                          and int(cfg.sched_prefetch_slots or 128))
                      else 0)
        # the flush wire: F_cap id slots per (source, owner) pair, or the
        # tighter a2a_flush_capacity, which the planner takes as its
        # per-owner budget (owner_cap) and defers planned flushes past
        self.flush_exchange = make_exchange(
            self.num_rows, S, self.F_cap,
            capacity=min(cfg.a2a_flush_capacity or self.F_cap, self.F_cap))

    # ------------------------------------------------------------------
    def make_planner(self, sparse_ids: np.ndarray, epochs: int = 1,
                     n_threads: int = 8,
                     assign_mode: str = "affinity") -> CachePlanner:
        return CachePlanner(
            sparse_ids, nrank=self.num_shards,
            batch_size=self.cfg.batch_size,
            cache_rows=self.cache_rows, num_shards=self.num_shards,
            rows_per_shard=self.exchange.rows_per_shard, epochs=epochs,
            flush_cap=self.F_cap,
            owner_cap=min(self.cfg.sched_flush_budget
                          or self.flush_exchange.capacity,
                          self.flush_exchange.capacity),
            top_k=self.cfg.sched_top_k_tables or 0, n_threads=n_threads,
            policy=self.cfg.cache_policy, assign_mode=assign_mode,
            pinned_rows=self.pinned_rows,
            bound=self.cfg.staleness_bound,
            unique_cap=self.U_cap,
            pull_target=self.cfg.sched_pull_target or 0,
            hoist_window=self.cfg.sched_hoist_window,
            prefetch_cap=self.P_cap,
            queue_cap=self.cfg.sched_queue_size,
            shuffle_seed=self.cfg.sched_shuffle_seed)

    def init_cached_state(self, seed: Optional[int] = None
                          ) -> CachedTrainState:
        """The base state (over S ranks, this rank's strided rows of one
        logical table), an empty cache, and the pinned tier: the hot block
        is the table's logical rows [0, P), so the two agree at step 0, with
        zero f32 slots, [P, W] on one device and this rank's block [P/S, W]
        over S ranks (1 row with no tier). Over S ranks each rank owns the
        rows r = rank (mod S) of [0, P) at its local slots [0, P/S), and an
        all-gather interleaves them."""
        base = super().init_state(seed)
        S, W, P = self.num_shards, self.width, self.pinned_rows
        cache = torch.zeros((self.cache_rows, 2 * W), dtype=torch.float32,
                            device=self.device)
        if P and S == 1:
            hot = base.table[:P].clone()
        elif P:
            owned = self.comm.all_gather(base.table[:P // S])  # [S, P/S, W]
            hot = owned.transpose(0, 1).reshape(P, W).contiguous()
        else:
            hot = torch.zeros((1, W), dtype=self.cfg.table_dtype,
                              device=self.device)
        hot_slots = {k: torch.zeros((P // S if P else 1, W),
                                    dtype=torch.float32, device=self.device)
                     for k in self.embed_opt.slot_names}
        return CachedTrainState(*base, cache=cache, hot_table=hot,
                                hot_slots=hot_slots)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    @staticmethod
    def _write(dst, a, name, src) -> None:
        """dst[targets] = src[positions] for one write of one step."""
        dst.index_copy_(0, a[f"{name}_tgt"], src.index_select(
            0, a[f"{name}_pos"]).to(dst.dtype))

    def _flush_phase(self, table, table_slots, cache, step, elr, a,
                     to_table: bool, to_cache: bool):
        """The flush, in place; returns this rank's overflow of the flush
        exchange over S ranks, None on one device. Over S ranks every rank
        runs it when any worker flushes (`to_table`)."""
        W = self.width
        fids = a["fids"]
        # full [F, 2W] rows: the value half is written back unchanged with
        # the delta half zeroed (slot C, padding, reads a zero row)
        frows = embedding_gather(cache, a["fslots"])
        deltas = frows[:, W:]
        overflow = None
        if self.num_shards == 1:
            # ids -1 read zero rows; they are masked and never written
            rows_idx, row_grads, row_mask = fids, deltas, fids >= 0
        else:
            # the owner's distinct local rows and their summed deltas; the
            # spare slots read the rows_per_shard sentinel, a zero row
            route = route_ids(self.flush_exchange, fids, fids >= 0,
                              self.comm)
            rows_idx, row_grads, _, row_mask = scatter_grads(
                self.flush_exchange, route, deltas, self.comm,
                wire_dtype=self.cfg.flush_wire_dtype)
            overflow = route.overflow
        rows = embedding_gather(table, rows_idx)
        row_slots = {k: embedding_gather(v, rows_idx)
                     for k, v in table_slots.items()}
        new_rows, new_slots = self.embed_opt.apply_rows(
            rows, row_grads.to(rows.dtype), row_slots, step, lr=elr,
            mask=row_mask)
        if self.num_shards > 1:
            write_rows(table, rows_idx, new_rows, row_mask)
            for k in table_slots:
                write_rows(table_slots[k], rows_idx, new_slots[k], row_mask)
        elif to_table:
            self._write(table, a, "ft", new_rows)
            for k in table_slots:
                self._write(table_slots[k], a, "ft", new_slots[k])
        if to_cache:
            residual = torch.zeros_like(deltas)
            if self.num_shards > 1 and self.cfg.flush_wire_dtype == \
                    torch.int8:
                # error feedback: what the int8 wire did not carry stays
                # in the delta plane for the row's next flush
                q, sc = rowquant_int8(deltas)
                residual = deltas - q.to(deltas.dtype) * sc[:, None].to(
                    deltas.dtype)
            self._write(cache, a, "fc", torch.cat([frows[:, :W], residual],
                                                  dim=1))
        return overflow

    def _cached_step_body(self, state: CachedTrainState, a, variant,
                          device_data=None):
        """One step of a staged chunk on its inputs `a` (one row of the
        chunk), in `variant` (`StagedChunk.steps`): (state, result), the
        result as `Engine._reduce` gives it (the loss on one device, [loss,
        overflow] summed over the group over S ranks). The table, its
        slots, the cache, the hot block, the dense params and the step are
        updated in place (JAX donates them); the slots of the dense params
        and of the hot block are new tensors."""
        to_table, to_cache, do_pull, insert, update = variant
        W, U = self.width, self.U_cap
        if "idx" in a:
            dev_d, dev_y = device_data
            idx = a["idx"]
            if idx.shape[0] == 1:
                # a row in stream order ships as its base (`_chunk_program`)
                idx = idx + torch.arange(self.cfg.batch_size,
                                         dtype=idx.dtype, device=idx.device)
            d = dev_d.index_select(0, idx)
            y = dev_y.index_select(0, idx)
        else:
            d, y = a["d"], a["y"]
        B = y.shape[0]
        inv = a["inv"].to(torch.int32)      # int16 on the narrowed wire
        step = state.step.add_(1)
        elr = self._elr_fn(step)
        S = self.num_shards
        table, table_slots, cache = state.table, state.table_slots, \
            state.cache
        # this rank's dropped ids over S ranks (None on one device)
        overflow = None if S == 1 else self._zero
        if to_table or to_cache:
            flushed = self._flush_phase(table, table_slots, cache, step, elr,
                                        a, to_table, to_cache)
            if flushed is not None:
                overflow = overflow + flushed
        if do_pull:
            pull_ids = a["pull_ids"]
            # f32 rows, widened by K1 as it reads them
            if S == 1:
                pulled = embedding_gather(table, pull_ids, torch.float32)
            else:
                route = route_ids(self.exchange, pull_ids, pull_ids >= 0,
                                  self.comm)
                pulled = gather_rows(self.exchange, table, route, self.comm,
                                     torch.float32)
                overflow = overflow + route.overflow
            if insert:
                # prefetched rows: both planes (their slots are virgin, so
                # the delta plane is already 0)
                pf = pulled[U:]
                self._write(cache, a, "pf",
                            torch.cat([pf, torch.zeros_like(pf)], dim=1))
        # phase 4: one fused read of value + delta planes (after the flush
        # zeroing, which is what makes the set-write of phase 5 exact)
        res2 = embedding_gather(cache, a["slots"])
        resident, delta_old = res2[:, :W], res2[:, W:]
        if do_pull:
            emb_uniq = torch.where((pull_ids[:U] >= 0).unsqueeze(1),
                                   pulled[:U], resident)
        else:
            emb_uniq = resident
        if self.pinned_rows:
            # K4's add form: its bounds check is the pinned mask, so rows
            # of ids -1 and ids >= P stay as they are and hot rows get the
            # widened hot row added, the sums of JAX's masked fill read
            # and add. In place: emb_uniq is this step's own tensor (res2's
            # value half, or the pull's torch.where)
            hot_onehot_gather_add_(emb_uniq, state.hot_table, a["uniq"])
        emb = emb_uniq.index_select(0, inv).reshape(B, -1, W)
        loss, dgrads, emb_grad = self._loss_and_grads(
            state.dense, emb, d, y, scale=None if S == 1 else 1.0 / S)
        dgrads, res = self._reduce(dgrads, loss, overflow)
        dense, dense_slots = self.dense_opt.apply_dense(
            state.dense, dgrads, state.dense_slots, step,
            lr=self._lr_fn(step), in_place=True)

        # phase 5: value plane = forward value - lr*grad quantized through
        # the table dtype; delta plane = post-flush delta + grad
        g_uniq = hot_onehot_push(inv, emb_grad.reshape(-1, W), U)
        if update:
            new_data = (emb_uniq - elr * g_uniq).to(
                self.cfg.table_dtype).to(torch.float32)
            self._write(cache, a, "up",
                        torch.cat([new_data, delta_old + g_uniq], dim=1))

        if self.pinned_rows:
            # exact synchronous SGD on the hot block: uniq holds each id
            # once, so the segment sum is a plain scatter of g_uniq
            hot_table, hot_slots = self._hot_update(state, step, elr,
                                                    a["uniq"], g_uniq)
        else:
            hot_table, hot_slots = state.hot_table, state.hot_slots
        new_state = CachedTrainState(
            table=table, table_slots=table_slots, dense=dense,
            dense_slots=dense_slots, step=step, cache=cache,
            hot_table=hot_table, hot_slots=hot_slots)
        return new_state, res

    def _hot_update(self, state: CachedTrainState, step, elr, uniq, g_uniq):
        """The pinned tier's update, the hot block in place: (hot block, new
        slots). K3 sums the delta of the P rows; over S ranks a
        reduce-scatter gives this rank the sum of its block of P/S rows,
        the optimizer moves the block with its slots, and an all-gather of
        the new rows in the table dtype fills the whole block (JAX's
        `psum_scatter` and `all_gather`, `cached.py:520-540`)."""
        P, S = self.pinned_rows, self.num_shards
        hot_delta = hot_onehot_push(uniq, g_uniq, P)
        hot = state.hot_table
        if S == 1:
            new, hot_slots = self.embed_opt.apply_rows(
                hot.to(torch.float32), hot_delta, state.hot_slots, step,
                lr=elr)
            return hot.copy_(new), hot_slots
        blk = P // S
        new, hot_slots = self.embed_opt.apply_rows(
            hot[self.rank * blk:(self.rank + 1) * blk].to(torch.float32),
            self.comm.reduce_scatter(hot_delta), state.hot_slots, step,
            lr=elr)
        return hot.copy_(self.comm.all_gather(new.to(hot.dtype)).reshape(
            P, self.width)), hot_slots

    # ------------------------------------------------------------------
    # staging
    # ------------------------------------------------------------------
    def _chunk_program(self, K, assign, slots, pulls, fids, fslots, pfids,
                       pfslots, uniq, inv, raw_dense=None, raw_sparse=None,
                       raw_labels=None, *, index_feed: bool):
        """The host side of staging one popped chunk (the first K rows of
        each array): (its step inputs {name: [K, ...] array}, each step's
        variant, the chunk's variant). The sparse rows never ship: the
        planner's uniq/inv replace them. The chunk's variant follows JAX's
        per-chunk rule, a pure function of the planner stream. Over S ranks
        the arrays hold every worker's columns ([K, S*X]): the phases are
        decided from all of them, and this rank stages its own block of
        each (worker `rank`'s program). On one device the packed wire
        narrows `inv` and a row in stream order (JAX's `_stage_chunk`,
        `cached.py:845-874`)."""
        cfg = self.cfg
        C, S = self.cache_rows, self.num_shards
        narrow = S == 1 and cfg.sched_packed_wire
        pulls = np.asarray(pulls[:K]).view(np.uint8).astype(bool)
        has_flush = (fids[:K] >= 0).any(axis=1)
        has_pull = pulls.any(axis=1) | (pfids[:K] >= 0).any(axis=1)
        noflush = bool(cfg.sched_noflush_variant and not has_flush.any())
        nopull = bool(noflush and cfg.sched_nopull_variant
                      and not has_pull.any())

        def mine(x):        # this rank's column block of [K, S*X]
            x = np.asarray(x[:K])
            w = x.shape[1] // S
            return x[:, self.rank * w:(self.rank + 1) * w]
        assign, slots, pulls, uniq, inv = (mine(x) for x in (
            assign, slots, pulls, uniq, inv))
        fids, fslots, pfids, pfslots = (mine(x) for x in (
            fids, fslots, pfids, pfslots))

        host = {}
        if index_feed:
            idx = np.asarray(assign, np.int32)
            # solo planning in stream order assigns base + arange(gb):
            # the step rebuilds the row from its base
            if narrow and idx.shape[1] > 1 and np.array_equal(
                    idx, idx[:, :1] + np.arange(idx.shape[1],
                                                dtype=np.int32)):
                idx = np.ascontiguousarray(idx[:, :1])
            host["idx"] = idx
        else:
            host["d"] = np.asarray(raw_dense[assign], np.float32)
            host["y"] = np.asarray(raw_labels[assign], np.float32)
        host["slots"] = np.asarray(slots, np.int32)
        # inv indexes the U_cap-wide unique list: the widest program array
        host["inv"] = np.asarray(inv, np.int16 if narrow and self.U_cap
                                 <= np.iinfo(np.int16).max else np.int32)
        pull_ids = np.where(pulls & (uniq >= 0), uniq, -1)
        host["pull_ids"] = np.concatenate([pull_ids, pfids],
                                          axis=1).astype(np.int32)
        host["fids"] = np.asarray(fids, np.int32)
        host["fslots"] = np.asarray(fslots, np.int32)
        if self.pinned_rows:
            host["uniq"] = np.asarray(uniq, np.int32)
        masks = {
            "fc": ((fslots >= 0) & (fslots < C), fslots),
            "pf": ((pfids >= 0) & (pfslots >= 0) & (pfslots < C), pfslots),
            "up": ((uniq >= 0) & (slots >= 0) & (slots < C), slots)}
        if S == 1:
            masks["ft"] = ((fids >= 0) & (fids < self.padded_rows), fids)
        kept = self._write_arrays(host, masks)
        flush = kept["ft"] if S == 1 else has_flush
        steps = tuple((bool(flush[k]), bool(kept["fc"][k]),
                       bool(has_pull[k]), bool(kept["pf"][k]),
                       bool(kept["up"][k])) for k in range(K))
        return host, steps, 2 if nopull else 1 if noflush else 0

    def _stage_chunk(self, K, assign, slots, pulls, fids, fslots, pfids,
                     pfslots, uniq, inv, raw_dense=None, raw_sparse=None,
                     raw_labels=None, *, index_feed: bool) -> StagedChunk:
        """Stage one popped chunk (the first K rows of each array) for
        `train_epoch_staged`: its packed steps (`_chunk_program`) in one
        copy from pinned host memory, on the current stream, or a memoized
        staged chunk of the same content (`_memo_stage`)."""
        with span("stage.program"):
            host, steps, variant = self._chunk_program(
                K, assign, slots, pulls, fids, fslots, pfids, pfslots, uniq,
                inv, raw_dense, raw_sparse, raw_labels, index_feed=index_feed)
        with span("stage.pack"):
            buf, layout = self._host_feed(host, K)
            if not (self.cfg.sched_packed_wire and self._memo_on):
                return StagedChunk(int(K), variant, index_feed, steps,
                                   self._copy(buf), layout)
            with span("stage.memo"):
                return self._memo_stage(int(K), variant, index_feed, steps,
                                        buf, layout)

    def _copy(self, buf):
        """A packed host chunk's copy to the device, without waiting."""
        with span("stage.copy"):
            return buf.to(self.device, non_blocking=True)

    def _memo_stage(self, K, variant, index_feed, steps, buf,
                    layout) -> StagedChunk:
        """Stage a packed host chunk `buf` ([K, nbytes], pinned on a card),
        reusing a memoized staged chunk when its content is equal (JAX's
        `_memo_stage`, `cached.py:905-972`). An epoch-repeat stream re-plans
        byte-identical programs, so recent chunks stay on the device, keyed
        by content, and the copy is skipped for an equal one. The key holds
        everything a `StagedChunk` carries but the bytes (variant, feed, K,
        each step's variant, layout) and samples the bytes; reuse needs
        the key equal AND the whole of the bytes equal. Over S ranks the
        steps' flush and pull flags come from every worker's columns, so a
        rank never reuses a chunk whose collectives differ.

        The memo keeps a pageable numpy copy of the host bytes and the
        staged chunk, each up to `sched_chunk_memo_mb`; the pinned buffer
        goes back to the caching host allocator as without the memo. An
        evicted chunk lives on while a queued step holds it. After 4x the
        budget has been evicted or replaced with no hit, the memo clears
        itself and turns off. The lock covers `_Prestager`'s pool; entries
        are never edited once published."""
        def staged():
            return StagedChunk(K, variant, index_feed, steps,
                               self._copy(buf), layout)
        if not self._memo_on:
            return staged()
        flat = buf.numpy().reshape(-1)
        key = (variant, index_feed, K, steps, layout, flat[:64].tobytes(),
               flat[-64:].tobytes())
        with self._memo_lock:
            hit = self._chunk_memo.get(key)
        if hit is not None and _same_bytes(flat, hit[0]):
            with self._memo_lock:
                if key in self._chunk_memo:
                    self._chunk_memo.move_to_end(key)
                self.memo_hits += 1
            return hit[1]
        out = staged()
        # the memo's own copy: on the CPU `out.packed` is `buf` itself
        mine = flat.copy()
        with self._memo_lock:
            if not self._memo_on:
                # a racing insert tripped the guard while this one staged
                return out
            prev = self._chunk_memo.get(key)
            if prev is None:
                self._memo_bytes += mine.nbytes
            else:
                # the same key, other bytes: replaced before any reuse,
                # churn as an eviction is (so the guard can trip)
                self._memo_evicted += prev[0].nbytes
            self._chunk_memo[key] = (mine, out)
            # the window slides in stream order: with a budget of an epoch
            # it holds the previous epoch, what the next one replays
            cap = self.cfg.sched_chunk_memo_mb << 20
            while self._memo_bytes > cap and self._chunk_memo:
                _, (old, _) = self._chunk_memo.popitem(last=False)
                self._memo_bytes -= old.nbytes
                self._memo_evicted += old.nbytes
            if self.memo_hits == 0 and self._memo_evicted > 4 * cap:
                self._chunk_memo.clear()
                self._memo_bytes = 0
                self._memo_on = False
        return out

    def staged_step_bytes(self, narrow: bool = True) -> int:
        """Bytes of one index-feed step of a staged chunk on the device
        (its packed row), from the program caps: a zero program through
        `_chunk_program`, its samples in stream order unless the planner
        shuffles. `narrow=False`: the row without the packed wire's
        narrowings (`inv` int32, `idx` a full row)."""
        S, P = self.num_shards, max(self.P_cap, 1)
        mbs, U, F = self.cfg.batch_size, self.U_cap, self.F_cap

        def zeros(w, dt=np.int32):
            return np.zeros((1, S * w), dt)
        assign = (zeros(mbs, np.int64) if self.cfg.sched_shuffle_seed
                  else np.arange(S * mbs, dtype=np.int64)[None])
        host, _, _ = self._chunk_program(
            1, assign, zeros(U), zeros(U, np.uint8), zeros(F),
            zeros(F), zeros(P), zeros(P), zeros(U),
            zeros(mbs * self.model.spec.num_sparse), index_feed=True)
        if not narrow:
            host["inv"] = host["inv"].astype(np.int32)
            host["idx"] = np.zeros((1, mbs), np.int32)
        return layout_of((k, TORCH_DTYPES[a.dtype], a.shape[1:])
                         for k, a in host.items()).nbytes

    def example_step_args(self):
        """Zero-filled device args of one cached step on this rank, in the
        step body's order: `_cached_step_body(state, *args)` with args
        (its inputs, a program of empty slots through `_chunk_program`;
        its variant). The variant runs the pull and, over S ranks, the
        flush, so that both exchanges move their buffers as JAX's compiled
        step does; every write of the flush is masked there and the cache
        is not written, so the table and the cache keep their values. For
        `utils.hlo_stats.collective_bytes(eng._cached_step_body, state,
        *eng.example_step_args(), comm=eng.comm)`."""
        S, P = self.num_shards, max(self.P_cap, 1)
        mbs, U, F = self.cfg.batch_size, self.U_cap, self.F_cap
        spec = self.model.spec

        def empty(w, fill, dt=np.int32):
            return np.full((1, S * w), fill, dt)
        C = self.cache_rows
        host, _, _ = self._chunk_program(
            1, empty(mbs, 0, np.int64), empty(U, C), empty(U, 0, np.uint8),
            empty(F, -1), empty(F, C), empty(P, -1), empty(P, C),
            empty(U, -1), empty(mbs * spec.num_sparse, 0),
            np.zeros((1, max(spec.num_dense, 0)), np.float32), None,
            np.zeros((1, 1), np.float32), index_feed=False)
        buf, layout = self._to_device(host, 1)
        return unpack(buf[0], layout), (S > 1, False, True, False, False)

    @staticmethod
    def _write_arrays(host, masks) -> Dict[str, np.ndarray]:
        """Each write's fixed-length lists into `host`; {write: any kept
        [K]}."""
        kept = {}
        for name in WRITES:
            if name in masks:
                mask, target = masks[name]
                host[f"{name}_tgt"], host[f"{name}_pos"], kept[name] = \
                    write_lists(mask, target)
        return kept

    def stage_dataset(self, raw_dense, raw_sparse, raw_labels):
        """The whole dataset's dense features and labels on the device,
        for `train_epoch_cached(device_data=...)`: per-chunk staging then
        ships int32 sample indices instead of sample rows, and the step
        gathers its rows on the device. The sparse ids are accepted but
        never staged: the planner's uniq/inv replace them."""
        return (torch.as_tensor(np.asarray(raw_dense, np.float32),
                                device=self.device),
                torch.as_tensor(np.asarray(raw_labels, np.float32),
                                device=self.device))

    def stage_program_chunks(self, planner, steps_per_chunk: int,
                             max_chunks: Optional[int] = None, raw=None):
        """Pop and stage up to `max_chunks` chunks ahead of time, for
        `train_epoch_staged`. Default staging is index-feed (pair with
        `stage_dataset`); `raw=(dense, sparse, labels)` stages direct-feed
        chunks, whose sample rows go to the device with the programs."""
        staged = []
        while max_chunks is None or len(staged) < max_chunks:
            out = planner.pop_chunk(steps_per_chunk)
            if out[0] == 0:
                break
            if raw is None:
                staged.append(self._stage_chunk(*out, index_feed=True))
            else:
                staged.append(self._stage_chunk(
                    *out, raw_dense=raw[0], raw_sparse=raw[1],
                    raw_labels=raw[2], index_feed=False))
        return staged

    # ------------------------------------------------------------------
    # host-facing API
    # ------------------------------------------------------------------
    def _run_chunk(self, state, staged: StagedChunk, device_data=None):
        if staged.index_feed:
            assert device_data is not None, \
                "an index-feed chunk needs stage_dataset data"
        S = self.num_shards
        # an index-feed step reads the dataset by address
        reads = tuple(device_data) if staged.index_feed else ()
        res = torch.zeros((2, staged.K), dtype=torch.float32,
                          device=self.device)     # loss; overflow
        # the dense-sync relaxation's cadence, as `train_epoch`'s
        step0 = int(state.step) if self._dsync_on and self.dsync_k > 1 \
            else 0
        with span("step.dispatch"):
            for k in range(staged.K):
                variant = staged.steps[k]
                state, _ = self._run(
                    ("cached", staged.index_feed, variant),
                    lambda st, a, v=variant: self._cached_step_body(
                        st, a, v, device_data),
                    state, (staged.packed[k], staged.layout),
                    out=res[:, k] if S > 1 else res[0, k], reads=reads)
                if self._dsync_on and (step0 + k + 1) % self.dsync_k == 0:
                    self._sync_dense(state)
        if self._dsync_on:
            self._sync_dense(state)
        return state, {"loss": res[0], "overflow": res[1].to(torch.int32)}

    def train_step_cached(self, state, planner: CachePlanner, raw_dense,
                          raw_sparse, raw_labels):
        """Pop one program and run it: (state, {"loss", "overflow"}), or
        (state, None) at the end of the stream. Over S ranks a dense-sync
        relaxation averages the dense state after the step, as JAX's
        single step does."""
        self._warn_per_step_dsync()
        out = planner.pop_chunk(1)
        if out[0] == 0:
            return state, None
        self._unsynced = True
        state, stats = self._run_chunk(state, self._stage_chunk(
            *out, raw_dense, raw_sparse, raw_labels, index_feed=False))
        return state, {"loss": stats["loss"][0],
                       "overflow": stats["overflow"][0]}

    @spanned("train.chunk")
    def train_epoch_cached(self, state, planner: CachePlanner, raw_dense,
                           raw_sparse, raw_labels, steps: int,
                           device_data=None):
        """Pop up to `steps` programs in one chunk and run them. With
        `device_data` (from `stage_dataset`) the sample rows are gathered
        on the device by assignment index; the raw_* arrays are then
        ignored. Returns (state, None) at the end of the stream. Under a
        profiler, the call is the span `train.chunk` (`utils/profiler.py`)."""
        (K, assign, slots, pulls, fids, fslots,
         pfids, pfslots, uniq, inv) = planner.pop_chunk(steps)
        if K == 0:
            return state, None
        if self._slot2id is not None:
            self._track_residency(K, slots, pfids, pfslots, uniq)
        return self.train_epoch_staged(
            state, self._stage_chunk(
                K, assign, slots, pulls, fids, fslots, pfids, pfslots,
                uniq, inv, raw_dense, raw_sparse, raw_labels,
                index_feed=device_data is not None),
            device_data=device_data)

    def train_epoch_staged(self, state, staged: StagedChunk,
                           device_data=None):
        """Run one staged chunk (from `_stage_chunk` /
        `stage_program_chunks`). Index-feed chunks need `device_data`."""
        self._unsynced = True
        if staged.variant >= 1:
            self.noflush_chunks += 1
        if staged.variant == 2:
            self.nopull_chunks += 1
        return self._run_chunk(state, staged, device_data)

    @staticmethod
    def to_base_state(state: CachedTrainState) -> TrainState:
        """View without cache arrays, for the base-engine eval path.
        Call sync_cache first so the owner table is up to date (it also
        writes the pinned hot block back into table[0:P])."""
        return TrainState(table=state.table, table_slots=state.table_slots,
                          dense=state.dense, dense_slots=state.dense_slots,
                          step=state.step)

    def _warn_if_unsynced(self):
        if self._unsynced:
            warnings.warn(
                "evaluating a cached state before sync_cache: the owner "
                "table is missing unflushed cache deltas"
                + (" and the trained pinned hot block"
                   if self.pinned_rows else "")
                + "; call sync_cache(state, planner) first for exact "
                  "results", UserWarning, stacklevel=3)

    def evaluate(self, state, dense_x, sparse_ids, labels, batch=None):
        if isinstance(state, CachedTrainState):
            self._warn_if_unsynced()
            state = self.to_base_state(state)
        return super().evaluate(state, dense_x, sparse_ids, labels, batch)

    def predict(self, state, dense_x, sparse_ids):
        if isinstance(state, CachedTrainState):
            self._warn_if_unsynced()
            state = self.to_base_state(state)
        return super().predict(state, dense_x, sparse_ids)

    def _flush_only(self, state: CachedTrainState, fids: np.ndarray,
                    fslots: np.ndarray) -> CachedTrainState:
        """The flush phase alone, at step + 1, on this rank's host arrays
        [Wf]; over S ranks every rank runs it (its exchange is a
        collective) and its overflow is dropped, as in JAX."""
        fids = np.asarray(fids, np.int64)[None]
        fslots = np.asarray(fslots, np.int64)[None]
        host = {"fids": fids.astype(np.int32),
                "fslots": fslots.astype(np.int32)}
        masks = {"fc": ((fslots >= 0) & (fslots < self.cache_rows), fslots)}
        if self.num_shards == 1:
            masks["ft"] = ((fids >= 0) & (fids < self.padded_rows), fids)
        kept = self._write_arrays(host, masks)
        buf, layout = self._to_device(host, 1)
        step = state.step + 1
        self._flush_phase(state.table, state.table_slots, state.cache, step,
                          self._elr_fn(step), unpack(buf[0], layout),
                          self.num_shards > 1 or bool(kept["ft"][0]),
                          bool(kept["fc"][0]))
        return state

    @torch.no_grad()
    def sync_cache(self, state, planner: CachePlanner):
        """Flush all residual dirty deltas to the owner table (end-of-run
        sync before eval/checkpoint), and write the pinned hot block back
        into the table's rows [0, P). In place. Over S ranks every rank
        reads every worker's dump (`BroadcastPlanner.dirty_rows`), flushes
        its own in the same number of F_cap-wide flush steps as every other
        rank, and writes its own rows of [0, P) back."""
        S, C = self.num_shards, self.cache_rows
        # dump first: it raises if the program stream was not drained,
        # before any state changes
        dumps = [planner.dirty_rows(z) for z in range(S)]
        if self.pinned_rows:
            # this rank's rows r = rank (mod S) of [0, P), local slots
            # [0, P/S)
            state.table[: self.pinned_rows // S].copy_(
                state.hot_table[self.rank::S].to(state.table.dtype))
        self._unsynced = False
        ids_z, slots_z = dumps[self.rank]
        max_n = max(len(i) for i, _ in dumps)
        if max_n == 0:
            return state
        # final-sync width: the per-step flush is F_cap wide, but the end
        # dump can hold the whole resident dirty set; on one device JAX
        # flushes it in a few wide calls of <= 128K rows, and so does the
        # port. Over S ranks the flush exchange is sized for F_cap
        Wf = self.F_cap
        if S == 1 and max_n > 4 * self.F_cap:
            Wf = 1 << min(int(np.ceil(np.log2(max_n))), 17)
        for off in range(0, max_n, Wf):
            fids = np.full(Wf, -1, np.int64)
            fslots = np.full(Wf, C, np.int32)
            chunk_ids = ids_z[off:off + Wf]
            fids[:len(chunk_ids)] = chunk_ids
            fslots[:len(chunk_ids)] = slots_z[off:off + Wf]
            state = self._flush_only(state, fids, fslots)
        return state

    # ------------------------------------------------------------------
    # serve-exact mid-stream views: the engine mirrors slot -> id
    # residency on the host from the programs it dispatches and computes
    # the synced values of every dirty row with the flush math, without
    # touching the training state (JAX: cached.py:1142-1268)
    # ------------------------------------------------------------------
    def _one_process(self, what: str) -> None:
        if self.num_shards > 1:
            raise NotImplementedError(
                f"{what} reads every worker's cache, which JAX's launcher "
                f"allows in one process only (--ckpt-serve-view, "
                f"herald_tpu/launch/cli.py:850-854); over "
                f"{self.num_shards} ranks the port runs one process a rank")

    def enable_residency_tracking(self, mirror: Optional[np.ndarray] = None
                                  ) -> None:
        """Start mirroring cache residency on the host. Must be enabled
        before the first dispatched chunk (or pass the `mirror` saved by a
        checkpoint when resuming). train_epoch_cached tracks at pop time
        (pop == dispatch there). One rank only."""
        self._one_process("residency tracking")
        if mirror is not None:
            mirror = np.asarray(mirror, np.int64)
            assert mirror.shape == (1, self.cache_rows), mirror.shape
            self._slot2id = mirror.copy()
        else:
            self._slot2id = np.full((1, self.cache_rows), -1, np.int64)

    def _track_residency(self, K, slots, pfids, pfslots, uniq) -> None:
        C = self.cache_rows
        # prefetch inserts first (their slots are virgin), then batch-key
        # writes win any later reuse
        pi, ps = pfids[:K].reshape(-1), pfslots[:K].reshape(-1)
        ok = (pi >= 0) & (ps < C)
        self._slot2id[0][ps[ok]] = pi[ok]
        u, s = uniq[:K].reshape(-1), slots[:K].reshape(-1)
        ok = (u >= 0) & (s < C)   # pinned keys carry the C sentinel
        self._slot2id[0][s[ok]] = u[ok]

    @torch.no_grad()
    def serve_overlay(self, state: CachedTrainState
                      ) -> Dict[str, np.ndarray]:
        """Synced values of every dirty cached row, as host arrays:
        {"rows": physical row indices, "values": [N, W] table-dtype rows,
        "slot/<name>": [N, W] slot rows, "mirror": the residency mirror,
        and (pinned tier) "hot_rows"/"hot_values"}; bf16 arrays are their
        bit patterns (`V2`), as a JAX checkpoint stores them. Apply with
        `apply_serve_overlay` (train/checkpoint.py) onto the base view of
        the same state. Dirtiness is `delta != 0` (exact for sgd/adagrad;
        JAX's caveats hold). The flush math here widens rows and deltas
        to f32, where the flush itself casts the delta to the table
        dtype, as in JAX."""
        from herald_tpu_torch.bridge import tensor_to_numpy
        self._one_process("serve_overlay")
        assert self._slot2id is not None, \
            "call enable_residency_tracking() before training"
        W = self.width
        dirty = (state.cache[:, W:] != 0).any(dim=1).cpu().numpy()
        out: Dict[str, np.ndarray] = {"mirror": self._slot2id.copy()}
        resident = np.nonzero(self._slot2id[0] >= 0)[0]
        sel = resident[dirty[resident]]
        gslots, gids = sel, self._slot2id[0][sel]
        # duplicate ids: keep the last occurrence (JAX's rule)
        _, last = np.unique(gids[::-1], return_index=True)
        keep = np.sort(len(gids) - 1 - last)
        gslots, gids = gslots[keep], gids[keep]
        if len(gids):
            phys = self.exchange.phys_index(gids)
            slot_t = torch.as_tensor(gslots, device=self.device)
            phys_t = torch.as_tensor(phys, device=self.device)
            deltas = embedding_gather(state.cache, slot_t)[:, W:]
            rows = embedding_gather(state.table, phys_t, torch.float32)
            sl = {k: embedding_gather(v, phys_t)
                  for k, v in state.table_slots.items()}
            step = state.step + 1
            mask = torch.ones(len(gids), dtype=torch.bool,
                              device=self.device)
            new_rows, new_sl = self.embed_opt.apply_rows(
                rows, deltas, sl, step,
                lr=self._elr_fn(step), mask=mask)
            out["rows"] = phys
            out["values"] = tensor_to_numpy(
                new_rows.to(state.table.dtype))[0]
            for k, v in new_sl.items():
                out[f"slot/{k}"] = tensor_to_numpy(
                    v.to(state.table_slots[k].dtype))[0]
        else:
            out["rows"] = np.zeros(0, np.int64)
            out["values"] = tensor_to_numpy(torch.zeros(
                (0, W), dtype=self.cfg.table_dtype))[0]
        if self.pinned_rows:
            out["hot_rows"] = self.exchange.phys_index(
                np.arange(self.pinned_rows, dtype=np.int64))
            out["hot_values"] = tensor_to_numpy(state.hot_table)[0]
        return out
