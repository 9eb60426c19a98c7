"""Engine, local mode (port of `herald_tpu/train/engine.py`).

One device, the whole table on it. Every step reads the batch's rows by
position: one K1 launch (`ops/kernels/gather.py`) over the `B*F` ids
writes the tower's f32 `[B, F, W]` input, as the JAX one-device SGD path
reads `table[ids]` and casts it (`engine.py:433-434`). The eval step
(`predict`, `evaluate`) runs the tower and a sigmoid on it, with no dedup.
The train step (`train_step`, `train_epoch`) adds the backward pass and
the sparse update, over a static-size dedup of the ids
(`ops.embedding.unique_static`, JAX's `jnp.unique(size=B*F,
fill_value=-1)`):

- SGD on the table (the JAX fast path, `engine.py:427-453`): the
  duplicate-id gradients are summed over the inverse through K3
  (`ops/kernels/segment.py`), and K2 (`ops/kernels/scatter.py`) adds
  `-lr * g` to each distinct row, scaling by the 0-d `lr` itself, and
  skips the -1 slots. JAX adds every duplicate's `-lr * g` straight into
  the table instead: the same sum, with one rounding per row here where
  JAX rounds once per duplicate.
- Every other table optimizer (the dedup path, `engine.py:315-355`): the
  emb gradient is rounded to the table dtype, as autograd rounds that of
  JAX's `emb.astype(f32)` (`engine.py:388-394`); K3 sums it per unique
  id, the rows and slots are read through K1, `apply_rows` updates them,
  and `write_rows` writes them back (JAX's scatter-set with
  `mode="drop"`, outside any Pallas kernel).

No step waits for the card: every shape is fixed, and a dropped write is
redirected on the card rather than filtered on the host. On the card
each step runs as a CUDA graph (`train/graphs.py`, the counterpart of
JAX's compiled steps): its inputs go in one packed copy, and the state's
tensors are the graph's state. `Engine(..., cuda_graphs=False)` runs the
same bodies uncaptured, for checks; on the CPU they always run so.

A step updates the table, its slots, the dense params and the step in
place, and the dense slots are new tensors (copied back into the old
ones under a graph): JAX donates the state to the step, so the state
handed in is consumed in both packages. The row-sharded hybrid exchange
comes in a later slice.

Entry points run on the card unless the caller passes `device="cpu"`;
with no device given and no card present they raise.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from herald_tpu_torch.config import HeraldConfig
from herald_tpu_torch.models.base import ModelDef, bce_with_logits, get_model
from herald_tpu_torch.ops.embedding import segment_sum_grads, unique_static
from herald_tpu_torch.ops.kernels import embedding_gather, rows_scatter_add
from herald_tpu_torch.optim import get_optimizer
from herald_tpu_torch.optim.schedules import get_schedule
from herald_tpu_torch.train.graphs import (TORCH_DTYPES, StepGraphs,
                                           feed_inputs, pack, pack_tensors)
from herald_tpu_torch.utils import metrics as M


class TrainState(NamedTuple):
    """All trainable state, as in the JAX package (`engine.py:38-44`)."""
    table: torch.Tensor                  # [padded_rows, width]
    table_slots: Dict[str, torch.Tensor]
    dense: Dict[str, torch.Tensor]
    dense_slots: Dict[str, Dict[str, torch.Tensor]]
    step: torch.Tensor                   # 0-d int32


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when none is given. Never falls back to the
    CPU: with no device and no card it raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "herald_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


class ExchangeSpec(NamedTuple):
    """The one-device form of `herald_tpu/parallel/exchange.py`'s spec:
    every row is local, the table pads to a multiple of 8 rows and a
    logical row is its own physical position. The row-sharded form comes
    with the hybrid exchange (ROADMAP queue 1, item 7)."""
    num_rows: int
    rows_per_shard: int
    capacity: int
    num_shards: int = 1

    @property
    def padded_rows(self) -> int:
        return self.num_shards * self.rows_per_shard

    def phys_index(self, ids):
        return (ids % self.num_shards) * self.rows_per_shard \
            + ids // self.num_shards


def make_exchange(num_rows: int, ids_per_step: int,
                  capacity: Optional[int] = None) -> ExchangeSpec:
    """`exchange.make_exchange` for one shard: capacity defaults to the
    ids of one step."""
    rows_per_shard = -(-num_rows // 8) * 8
    return ExchangeSpec(num_rows, rows_per_shard,
                        ids_per_step if capacity is None else int(capacity))


def write_rows(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
               keep: Optional[torch.Tensor] = None) -> None:
    """dst[idx] = vals in dst's dtype, dropping the entries outside dst or,
    when given, where `keep` is False (the JAX `.at[].set(mode="drop")`),
    at fixed shapes and with no wait for the card. A dropped entry takes a
    kept entry's index and value, so `index_copy_`'s duplicates write the
    same bytes; the dropped entries are spread over the kept ones in turn
    (the j-th over kept entry j mod kept), since thousands of writes to
    one row serialize on the card. With none kept, row 0's own value goes
    back into row 0. A dropped entry changes no bit of dst."""
    n = idx.shape[0]
    if n == 0:
        return
    if keep is None:
        keep = (idx >= 0) & (idx < dst.shape[0])
    pos = torch.arange(n, device=idx.device)
    rank = torch.cumsum(keep, 0)            # kept entries before, and it
    kept = rank[-1:]
    # kept entry r (from 0) at position at[r]; the dropped ones at n
    at = torch.zeros(n + 1, dtype=torch.long, device=idx.device).scatter_(
        0, torch.where(keep, rank - 1, n), pos)
    src = torch.where(keep, pos, at.index_select(0, pos % kept.clamp(min=1)))
    any_kept = kept > 0
    tgt = torch.where(any_kept, idx.index_select(0, src), 0).long()
    dst.index_copy_(0, tgt, torch.where(
        any_kept[:, None], vals.index_select(0, src).to(dst.dtype), dst[:1]))


class Engine:
    """Trains and scores one model over a table on one device."""

    def __init__(self, cfg: HeraldConfig, model: Optional[ModelDef] = None,
                 table_rows: Optional[int] = None, device=None,
                 cuda_graphs: bool = True):
        if cfg.comm_mode != "local":
            raise NotImplementedError(
                f"comm_mode={cfg.comm_mode!r}: the row-sharded all-to-all "
                f"exchange comes in a later slice of the port (ROADMAP "
                f"queue 1, multi-rank plain engine); use comm_mode='local'")
        self.cfg = cfg
        self.model = model or get_model(cfg.model)
        self.device = resolve_device(device or cfg.device)
        # the tower runs in f32 and is held to the JAX package at f32
        # tolerances: keep TF32 out of matrix products and convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.width = self.model.emb_width(cfg.embedding_dim)
        self.num_rows = table_rows or self.model.table_rows
        # one device: the JAX local engine's num_shards = 1, and its
        # exchange pads the table to a multiple of 8 rows
        # (parallel/exchange.py:93-94); kept so checkpoints interchange
        self.num_shards = 1
        self.ids_per_worker = cfg.batch_size * self.model.spec.num_sparse
        self.exchange = make_exchange(self.num_rows, self.ids_per_worker,
                                      cfg.a2a_pull_capacity)
        self.padded_rows = self.exchange.padded_rows
        self.dense_opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
        self.embed_opt = get_optimizer(cfg.embed_optimizer,
                                       cfg.embed_learning_rate)
        sched_kw = cfg.lr_schedule_kwargs or {}
        self._lr_fn = get_schedule(cfg.lr_schedule, cfg.learning_rate,
                                   **sched_kw)
        self._elr_fn = get_schedule(cfg.lr_schedule,
                                    cfg.embed_learning_rate, **sched_kw)
        self._fast_local_sgd = (self.embed_opt.name == "sgd"
                                and not cfg.use_cache)
        # a step's overflow count: one device and no exchange, so always 0
        self._zero = torch.zeros((), dtype=torch.int32, device=self.device)
        # the steps' CUDA graphs on a card; cuda_graphs=False runs the same
        # bodies uncaptured there, as on the CPU
        self.graphs = (StepGraphs(self.device)
                       if cuda_graphs and self.device.type == "cuda"
                       else None)

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Random state from a seed: table ~ 0.01 * N(0, 1), generated
        directly in `table_dtype` on the device (no f32 intermediate: at
        full width that would be 17 GB), zero table slots in the table
        dtype, then the tower and its zero slots (`{name: {}}` for a
        slotless optimizer, as JAX's tree has it)."""
        seed = self.cfg.seed if seed is None else seed
        gen = torch.Generator(device=self.device).manual_seed(seed)
        table = torch.randn((self.padded_rows, self.width), generator=gen,
                            dtype=self.cfg.table_dtype, device=self.device)
        table.mul_(0.01)
        slots = {k: torch.zeros_like(table)
                 for k in self.embed_opt.slot_names}
        dense = self.model.init_dense(gen, self.cfg.embedding_dim)
        dense_slots = {k: self.dense_opt.init_slots(v)
                       for k, v in dense.items()}
        step = torch.zeros((), dtype=torch.int32, device=self.device)
        return TrainState(table=table, table_slots=slots, dense=dense,
                          dense_slots=dense_slots, step=step)

    # ------------------------------------------------------------------
    def _read(self, table, ids):
        """ids [B, F] -> f32 [B, F, W]: one K1 read by position, widened in
        the kernel; ids outside the table give zero rows (the JAX engine's
        `mode="fill"` read). A row that several positions read comes from
        the card's L2 after the first, so on one device a dedup would save
        the read nothing (the JAX eval path dedups for its multi-shard
        exchange, `engine.py:301-313`)."""
        B, F = ids.shape
        emb = embedding_gather(table, ids.reshape(-1), torch.float32)
        return emb.reshape(B, F, self.width)

    def _dedup_read(self, table, ids):
        """ids [B, F] -> (f32 emb [B, F, W] read by position, uniq [B*F],
        inv): the training steps' read, and the static-size dedup their
        sparse update sums and writes over (-1 in the spare slots)."""
        uniq, inv = unique_static(ids, ids.numel())
        return self._read(table, ids), uniq, inv

    def _loss_and_grads(self, dense, emb, dense_x, labels):
        """(loss, {name: dense grad}, emb grad): `value_and_grad` with
        respect to the dense params and the f32 `emb`."""
        params = {k: v.detach().requires_grad_(True)
                  for k, v in dense.items()}
        emb = emb.detach().requires_grad_(True)
        with torch.enable_grad():
            logits = self.model.apply(params, emb, dense_x)
            loss = bce_with_logits(logits, labels)
            grads = torch.autograd.grad(loss, [*params.values(), emb])
        return loss.detach(), dict(zip(params, grads[:-1])), grads[-1]

    def _apply_sparse_grads(self, table, slots, step, uniq, inv, emb_grad):
        """Sum the grads per unique id (K3, in f32, rounded once to the
        grads' dtype), cast the sums to the table dtype, update the rows
        and slots with the table optimizer, write them back. In place.
        Slots of negative ids (the dedup's spare slots, the FAE step's -1
        at hot positions) are masked and dropped."""
        g_uniq = segment_sum_grads(emb_grad, inv, uniq.shape[0]).to(
            table.dtype)
        row_mask = uniq >= 0
        safe_idx = torch.where(row_mask, uniq, 0)
        rows = embedding_gather(table, safe_idx)
        row_slots = {k: embedding_gather(v, safe_idx)
                     for k, v in slots.items()}
        new_rows, new_slots = self.embed_opt.apply_rows(
            rows, g_uniq, row_slots, step,
            lr=self._elr_fn(step), mask=row_mask)
        keep = row_mask & (uniq < table.shape[0])
        write_rows(table, uniq, new_rows, keep)
        for k in slots:
            write_rows(slots[k], uniq, new_slots[k], keep)
        return table, slots

    def _train_step_body(self, state: TrainState, a):
        """One step on the inputs `a` ("d", "s", "y"): (state, loss)."""
        if self._fast_local_sgd:
            return self._train_step_body_fast(state, a["d"], a["s"], a["y"])
        step = state.step.add_(1)
        emb, uniq, inv = self._dedup_read(state.table, a["s"])
        loss, dgrads, emb_grad = self._loss_and_grads(state.dense, emb,
                                                      a["d"], a["y"])
        dense, dense_slots = self.dense_opt.apply_dense(
            state.dense, dgrads, state.dense_slots, step,
            lr=self._lr_fn(step), in_place=True)
        # the grad of a table-dtype leaf cast to f32, as JAX's is
        table, table_slots = self._apply_sparse_grads(
            state.table, state.table_slots, step, uniq, inv,
            emb_grad.to(state.table.dtype))
        new_state = TrainState(table=table, table_slots=table_slots,
                               dense=dense, dense_slots=dense_slots,
                               step=step)
        return new_state, loss

    def _train_step_body_fast(self, state: TrainState, dense_x, ids, labels):
        """SGD on the table: K1 read, f32 emb grads summed per distinct id
        through K3, `-lr * g` added through K2. JAX casts the gather to f32
        before `value_and_grad`, so its emb grad is f32, as here."""
        step = state.step.add_(1)
        emb, uniq, inv = self._dedup_read(state.table, ids)
        loss, dgrads, emb_grad = self._loss_and_grads(state.dense, emb,
                                                      dense_x, labels)
        dense, dense_slots = self.dense_opt.apply_dense(
            state.dense, dgrads, state.dense_slots, step,
            lr=self._lr_fn(step), in_place=True)
        g_uniq = segment_sum_grads(emb_grad, inv, uniq.shape[0])   # f32
        table = rows_scatter_add(state.table, uniq, g_uniq,
                                 lr=self._elr_fn(step))
        new_state = TrainState(table=table, table_slots=state.table_slots,
                               dense=dense, dense_slots=dense_slots,
                               step=step)
        return new_state, loss

    def _eval_step_body(self, state: TrainState, a):
        """Probabilities [B] of the inputs `a` ("d", "s"): (state, probs)."""
        logits = self.model.apply(state.dense, self._read(state.table,
                                                          a["s"]), a["d"])
        return state, torch.sigmoid(logits)

    # ------------------------------------------------------------------
    # feeding steps
    # ------------------------------------------------------------------
    def _run(self, name, body, state, feed, out=None, reads=()):
        """One step of `body` on a feed (`train/graphs.py`): replayed as a
        CUDA graph on a card, run as it is otherwise. (state, result)."""
        if self.graphs is not None:
            return self.graphs.run(name, body, state, feed, out, reads)
        new_state, res = body(state, feed_inputs(feed, self.device))
        return new_state, (res if out is None else out.copy_(res))

    def _host_feed(self, arrays: Dict[str, np.ndarray], steps=None):
        """Host arrays -> a feed: packed, pinned on a card, one copy."""
        return pack(arrays, steps, pin=self.device.type == "cuda")

    def _to_device(self, arrays: Dict[str, np.ndarray], steps=None):
        """Host arrays -> (packed uint8 buffer on the device, layout): ONE
        copy from pinned memory, without waiting."""
        buf, layout = self._host_feed(arrays, steps)
        return buf.to(self.device, non_blocking=True), layout

    def _batch_feed(self, spec: Dict[str, tuple]):
        """{name: (array or tensor, dtype)} of one batch -> a feed. Tensors
        on the engine's card are fed as they are; anything else is packed
        on the host. [W, B, ...] flattens to [W*B, ...] as in JAX."""
        def flat(x):
            return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]) \
                if x.ndim >= 3 else x

        if self.device.type == "cuda" and all(
                isinstance(x, torch.Tensor) and x.is_cuda
                and self.device.index in (None, x.device.index)
                for x, _ in spec.values()):
            return {k: flat(x.to(TORCH_DTYPES[np.dtype(dt)]))
                    for k, (x, dt) in spec.items()}
        return self._host_feed({
            k: flat((x.cpu().numpy() if isinstance(x, torch.Tensor)
                     else np.asarray(x)).astype(dt, copy=False))
            for k, (x, dt) in spec.items()})

    # ------------------------------------------------------------------
    def train_step(self, state: TrainState, dense_x, sparse_ids, labels):
        """One step on one batch: (state, {"loss", "overflow"}). The state
        handed in is consumed."""
        state, loss = self._run("train", self._train_step_body, state,
                                self._batch_feed({
                                    "d": (dense_x, np.float32),
                                    "s": (sparse_ids, np.int32),
                                    "y": (labels, np.float32)}))
        return state, {"loss": loss, "overflow": self._zero}

    def train_epoch(self, state: TrainState, dense_x, sparse_ids, labels,
                    steps: Optional[int] = None):
        """Run `steps` steps (default: as many full batches as the arrays
        hold). Host arrays are flat ([steps*B, ...]) and go to the device
        packed, one step a row, in one copy; tensors already shaped
        [steps, B, ...] are packed on their card. Returns (state, stats)
        with per-step `loss` and `overflow` tensors [steps]. Each step is
        one replay of the step's graph (JAX scans the steps in one
        program)."""
        gb = self.cfg.batch_size
        steps = steps or len(sparse_ids) // gb
        if steps < 1:
            raise ValueError(f"not enough samples for one step of {gb}")
        spec = {"d": (dense_x, np.float32), "s": (sparse_ids, np.int32),
                "y": (labels, np.float32)}

        def staged(x):      # a tensor already shaped [steps, B, ...]
            return isinstance(x, torch.Tensor) and x.dim() >= 2 \
                and x.shape[0] == steps

        def host(x, dt):
            a = np.asarray(x)[: steps * gb].astype(dt, copy=False)
            return a.reshape(steps, gb, *a.shape[1:])

        if any(staged(x) for x, _ in spec.values()):
            buf, layout = pack_tensors({
                k: (x if staged(x) else torch.as_tensor(host(x, dt))).to(
                    self.device, TORCH_DTYPES[np.dtype(dt)])
                for k, (x, dt) in spec.items()}, steps)
        else:
            buf, layout = self._to_device(
                {k: host(x, dt) for k, (x, dt) in spec.items()}, steps)
        losses = torch.empty(steps, dtype=torch.float32, device=self.device)
        for k in range(steps):
            state, _ = self._run("train", self._train_step_body, state,
                                 (buf[k], layout), out=losses[k])
        return state, {"loss": losses,
                       "overflow": torch.zeros(steps, dtype=torch.int32,
                                               device=self.device)}

    def train_epoch_assigned(self, state: TrainState, scheduler, dense_x,
                             sparse_ids, labels, steps: int):
        """Assign-only mode: `train_epoch` over the batches the lookahead
        scheduler (`sched/scheduler.py`, csrc/herald_sched.cc) composes,
        without the hot-row cache. Up to `steps` assignments are popped;
        each step trains on the samples it lists, in its order. Returns
        (state, None) when the scheduler's stream has ended. On one device
        a step's sample set is the plain step's, in another order."""
        idx_rows = []
        for _ in range(steps):
            r = scheduler.pop()
            if r is None:
                break
            idx_rows.append(r[0].reshape(-1))
        if not idx_rows:
            return state, None
        idx = np.concatenate(idx_rows)
        return self.train_epoch(state, dense_x[idx], sparse_ids[idx],
                                labels[idx], steps=len(idx_rows))

    @torch.inference_mode()
    def predict(self, state: TrainState, dense_x, sparse_ids
                ) -> torch.Tensor:
        """Probabilities [B] of one batch, on the engine's device."""
        return self._run("eval", self._eval_step_body, state,
                         self._batch_feed({"d": (dense_x, np.float32),
                                           "s": (sparse_ids, np.int32)}))[1]

    @torch.inference_mode()
    def evaluate(self, state: TrainState, dense_x, sparse_ids, labels,
                 batch: Optional[int] = None) -> Dict[str, float]:
        """Full-dataset AUC and accuracy. The tail is padded to a full
        batch by repeating the last sample and its extra predictions are
        dropped, so every sample is scored once. Batches go in blocks of
        up to T=32: one copy to the device and one back per block."""
        n = len(sparse_ids)
        if n == 0:
            return {"auc": 0.5, "acc": float("nan")}
        batch = batch or self.cfg.batch_size
        nb = -(-n // batch)
        T = min(32, nb)
        blocks = -(-nb // T)
        rows = T * batch
        d_all = np.asarray(dense_x, np.float32)
        s_all = np.asarray(sparse_ids, np.int32)
        total = blocks * rows
        if total > n:
            pad = total - n
            d_all = np.concatenate([d_all,
                                    np.repeat(d_all[-1:], pad, axis=0)])
            s_all = np.concatenate([s_all,
                                    np.repeat(s_all[-1:], pad, axis=0)])
        preds = []
        for b in range(blocks):
            sl = slice(b * rows, (b + 1) * rows)
            buf, layout = self._to_device({
                "d": d_all[sl].reshape(T, batch, *d_all.shape[1:]),
                "s": s_all[sl].reshape(T, batch, *s_all.shape[1:])}, T)
            p = torch.empty((T, batch), dtype=torch.float32,
                            device=self.device)
            for t in range(T):
                self._run("eval", self._eval_step_body, state,
                          (buf[t], layout), out=p[t])
            preds.append(p.reshape(-1).cpu().numpy())
        y_score = np.concatenate(preds)[:n]
        y_true = np.asarray(labels).reshape(-1)[: len(y_score)]
        return {
            "auc": M.auc_score(y_true, y_score),
            "acc": M.accuracy(y_true, y_score),
        }
