"""FAE baseline: hot/cold split embeddings (port of
`herald_tpu/train/fae.py`).

The most frequent ids ("hot", 1% of the rows by default) live in a dense
block `hot_table` [H, W] trained beside the tower; the other ("cold") ids
go through the plain engine's table. `build_hot_lut` profiles the training
ids once and maps each hot id to its row of the block.

A step on one device:
- the cold read: one K1 launch by position into f32 (`Engine._read`); the
  cold ids are -1 at hot positions, which K1 reads as zero rows;
- the hot read: one launch of K4's add form (`hot_onehot_gather_add_`)
  adds each hot position's row of the block into those zero rows, in
  place. JAX takes `where(is_hot, hot_emb.f32, cold_emb.f32)`
  (`fae.py:101-106`); the one bit that differs is a hot row holding -0.0,
  which reads as +0.0 (0.0 + -0.0) here. The two compare equal;
- the tower's loss and gradients, the dense update;
- the cold update: the cold ids deduped at the static size B*F
  (`unique_static`, JAX's `jnp.unique(size=U, fill_value=-1)`), the f32
  emb gradient summed per distinct cold id through K3, cast once to the
  table dtype, applied by the table optimizer and written back
  (`Engine._apply_sparse_grads`, whatever the optimizer: JAX's FAE step
  never takes the SGD fast path). JAX zeroes the hot positions'
  gradients (`fae.py:127`) and sums the zeros into the -1 id's row,
  which it drops. Here the hot positions point at slot U, past every
  slot, so K3 drops them: at a 99% hot share that row would be one
  segment of thousands of positions;
- the hot update: K3 sums the emb gradient by hot row into H rows (ids -1
  are dropped), and the embedding optimizer moves all H rows in f32, with
  f32 slots, as `fae.py:137-150` does; the rows are cast back into the
  block in place.

A step's four inputs go to the card packed in one copy from pinned
memory, and the step waits for the card nowhere; on a card it replays as
a CUDA graph (`train/graphs.py`).

Over S ranks (`comm_mode="hybrid"`, `fae.py:97-151`) the cold table is
row-sharded as the plain hybrid engine's is and the hot block and its
slots are replicated; every entry point takes the global batch
(`batch_size * S` rows), split on the host, and rank r runs block r:
- the cold read goes through the exchange (`Engine._sparse_read`): the -1
  at hot positions is one entry of the dedup, masked as JAX's
  `valid = uniq >= 0` masks it, so it is routed nowhere, counts no
  overflow and reads a zero row; K4's add form then reads the hot rows
  into those rows as on one device;
- the loss is scaled by 1/S, and the dense grads, the loss and the
  overflow are summed in one all-reduce (`Engine._reduce`);
- the cold update sums the f32 emb gradient per unique id (K3; the hot
  positions again point past every slot), sends the f32 sums to their
  owners (`scatter_grads`, JAX's f32 wire) and casts there;
- the hot update: K3 sums this rank's hot gradient into [H, W] f32, one
  all-reduce sums it over the ranks (JAX's `psum` of `g_hot`), and every
  rank moves all H rows alike, so the hot block and its slots stay
  bit-identical on every rank;
- a dense-sync relaxation syncs the dense state after every step, as
  JAX's FAE step does; the steps run uncaptured.
`evaluate_fae` reads through the eval exchange and raises on its
overflow, as `Engine.evaluate` does, where JAX's FAE eval reads through
the training exchange and drops its overflow (ROADMAP queue 3).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from herald_tpu_torch.config import HeraldConfig
from herald_tpu_torch.models.base import ModelDef, get_model
from herald_tpu_torch.ops.kernels import (hot_onehot_gather_add_,
                                          hot_onehot_push)
from herald_tpu_torch.train.engine import Engine, refuse_bags
from herald_tpu_torch.utils import metrics as M


def build_hot_lut(sparse_ids: np.ndarray, num_rows: int,
                  hot_rate: float = 0.01,
                  num_hot: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Profile id frequencies; return (lut, hot_ids): lut[id] is the id's
    row of the hot block in [0, H), or -1 for a cold id. Ties in frequency
    go to the smaller id (a stable sort of the sorted unique ids)."""
    if num_hot is None:
        num_hot = max(1, int(num_rows * hot_rate))
    ids, counts = np.unique(sparse_ids.reshape(-1), return_counts=True)
    order = np.argsort(-counts, kind="stable")
    hot_ids = ids[order[:num_hot]]
    lut = np.full(num_rows, -1, np.int32)
    lut[hot_ids] = np.arange(len(hot_ids), dtype=np.int32)
    return lut, hot_ids


class FaeTrainState(NamedTuple):
    """JAX's `FaeTrainState`: the same fields, in the same order."""
    table: torch.Tensor                  # cold table [padded_rows, W]
    table_slots: Dict[str, torch.Tensor]
    dense: Dict[str, torch.Tensor]
    dense_slots: Dict[str, Dict[str, torch.Tensor]]
    step: torch.Tensor
    hot_table: torch.Tensor              # [H, W] in the table dtype
    hot_slots: Dict[str, torch.Tensor]   # each [H, W] f32


class FaeEngine(Engine):
    """Engine with the hot/cold split."""

    def __init__(self, cfg: HeraldConfig, model: Optional[ModelDef] = None,
                 table_rows: Optional[int] = None, hot_rate: float = 0.01,
                 num_hot: Optional[int] = None, device=None,
                 cuda_graphs: bool = True):
        refuse_bags(model or get_model(cfg.model), "the FAE engine")
        if cfg.comm_mode == "hybrid" and cfg.mp_shards > 1:
            # JAX's FaeEngine shards its step over the dp axis alone and
            # runs a different computation at mp > 1 (ROADMAP section 3)
            raise ValueError(
                "mp_shards > 1 is not supported by the FAE engine: its "
                "step, hot block and tower are data-parallel only; train "
                "the plain hybrid engine with mp_shards > 1")
        super().__init__(cfg, model=model, table_rows=table_rows,
                         device=device, cuda_graphs=cuda_graphs)
        # of the logical rows, not the padded ones
        self.num_hot = num_hot or max(1, int(self.num_rows * hot_rate))

    def init_fae_state(self, seed: Optional[int] = None) -> FaeTrainState:
        """The base state from `seed` (over S ranks, this rank's strided
        rows of one logical table), then the hot block ~ 0.01 * N(0, 1)
        in f32 from seed + 7, cast to the table dtype, and its zero f32
        slots: the one-device engine's block on every rank."""
        base = super().init_state(seed)
        seed = self.cfg.seed if seed is None else seed
        gen = torch.Generator(device=self.device).manual_seed(seed + 7)
        hot = torch.randn((self.num_hot, self.width), generator=gen,
                          dtype=torch.float32, device=self.device)
        hot = hot.mul_(0.01).to(self.cfg.table_dtype)
        hot_slots = {k: torch.zeros((self.num_hot, self.width),
                                    dtype=torch.float32, device=self.device)
                     for k in self.embed_opt.slot_names}
        return FaeTrainState(*base, hot_table=hot, hot_slots=hot_slots)

    # ------------------------------------------------------------------
    def _hot_add(self, emb, state: FaeTrainState, hot_idx):
        """One K4 add of the hot rows (hot_idx, -1 where cold) into the
        f32 emb [B, F, W] in place; returns emb."""
        hot_onehot_gather_add_(emb.view(-1, self.width), state.hot_table,
                               hot_idx.reshape(-1))
        return emb

    def _fae_read(self, state: FaeTrainState, ids, hot_idx):
        """ids (cold, -1 where hot), hot_idx (hot row, -1 where cold)
        [B, F] -> f32 [B, F, W] on one device: one K1 read by position,
        then one K4 add of the hot rows in place."""
        return self._hot_add(self._read(state.table, ids), state, hot_idx)

    def _apply_hot_grads(self, hot_table, hot_slots, step, g_hot):
        """The embedding optimizer over every row of the hot block, in f32
        (under adam every row moves each step); the rows go back into the
        block, in the table dtype, in place."""
        rows, slots = self.embed_opt.apply_rows(
            hot_table.float(), g_hot, hot_slots, step, lr=self._elr_fn(step))
        return hot_table.copy_(rows), slots

    def _fae_step_body(self, state: FaeTrainState, a):
        """One step on this rank's inputs `a` ("d", "cold", "hot", "y"):
        (state, result), the result as `Engine._reduce` gives it: the loss
        on one device, [loss, overflow] summed over the group over S
        ranks."""
        step = state.step.add_(1)
        ids, hot_idx = a["cold"], a["hot"]
        flat = ids.reshape(-1)
        U = flat.numel()
        emb, uniq, inv, route = self._sparse_read(state.table, ids,
                                                  self.exchange)
        self._hot_add(emb, state, hot_idx)
        # the hot positions' gradients go past every slot: K3 drops them
        inv = torch.where(flat >= 0, inv, U)
        loss, dgrads, emb_grad = self._loss_and_grads(
            state.dense, emb, a["d"], a["y"],
            scale=None if route is None else 1.0 / self.num_shards)
        dgrads, res = self._reduce(dgrads, loss,
                                   None if route is None else route.overflow)
        dense, dense_slots = self.dense_opt.apply_dense(
            state.dense, dgrads, state.dense_slots, step,
            lr=self._lr_fn(step), in_place=True)
        table, table_slots = self._apply_sparse_grads(
            state.table, state.table_slots, step, uniq, inv, emb_grad, route)
        g_hot = hot_onehot_push(hot_idx.reshape(-1),
                                emb_grad.reshape(-1, self.width),
                                self.num_hot)
        if route is not None:
            self.comm.all_reduce_(g_hot)
        hot_table, hot_slots = self._apply_hot_grads(
            state.hot_table, state.hot_slots, step, g_hot)
        new_state = FaeTrainState(
            table=table, table_slots=table_slots, dense=dense,
            dense_slots=dense_slots, step=step, hot_table=hot_table,
            hot_slots=hot_slots)
        return new_state, res

    def _fae_eval_body(self, state: FaeTrainState, a):
        """Probabilities [B] of this rank's inputs. Over S ranks the cold
        ids go through the eval exchange, whose overflow adds to
        `_eval_overflow`."""
        if self.num_shards == 1:
            emb = self._fae_read(state, a["cold"], a["hot"])
        else:
            emb, _, _, route = self._sparse_read(state.table, a["cold"],
                                                 self.eval_exchange)
            self._hot_add(emb, state, a["hot"])
            self._eval_overflow += route.overflow
        return state, torch.sigmoid(self.model.apply(state.dense, emb,
                                                     a["d"]))

    # ------------------------------------------------------------------
    def split_batch(self, lut: np.ndarray, sparse_ids: np.ndarray):
        """Host split: (cold ids with -1 at hot positions, hot_idx)."""
        hot_idx = lut[sparse_ids]
        cold = np.where(hot_idx >= 0, -1, sparse_ids)
        return cold.astype(np.int32), hot_idx.astype(np.int32)

    def train_step_fae(self, state: FaeTrainState, lut, dense_x, sparse_ids,
                       labels):
        """One step on one global batch (`batch_size * S` rows): (state,
        {"loss", "overflow"}). The batch is split on the host, and this
        rank's block of its four arrays goes to the card in one copy; the
        state handed in is consumed. A dense-sync relaxation averages the
        dense state after the step, as JAX's FAE step does."""
        self._warn_per_step_dsync()
        cold, hot_idx = self.split_batch(lut, np.asarray(sparse_ids))
        state, res = self._run("fae", self._fae_step_body, state,
                               self._batch_feed({
                                   "d": (dense_x, np.float32),
                                   "cold": (cold, np.int32),
                                   "hot": (hot_idx, np.int32),
                                   "y": (labels, np.float32)}))
        if self._dsync_on:
            self._sync_dense(state)
        if self.num_shards == 1:
            return state, {"loss": res, "overflow": self._zero}
        return state, {"loss": res[0], "overflow": res[1].to(torch.int32)}

    @torch.inference_mode()
    def evaluate_fae(self, state: FaeTrainState, lut, dense_x, sparse_ids,
                     labels, batch: Optional[int] = None
                     ) -> Dict[str, float]:
        """AUC and accuracy over the whole batches only: a tail shorter
        than `batch` (default: the global batch) is not scored, as in JAX
        (`fae.py:230`). The batches go to the card in one copy and come
        back in one. Over S ranks each rank scores its block of every
        batch, the probabilities are gathered in sample order, and the
        eval exchange's overflow raises."""
        S = self.num_shards
        batch = batch or self.cfg.batch_size * S
        nb = len(sparse_ids) // batch
        y_true = np.asarray(labels).reshape(-1)[: nb * batch]
        if nb == 0:
            return {"auc": M.auc_score(y_true, np.zeros(0)),
                    "acc": M.accuracy(y_true, np.zeros(0))}
        n = nb * batch
        sparse = np.asarray(sparse_ids)[:n]
        dense = np.asarray(dense_x, np.float32)[:n]
        cold, hot_idx = self.split_batch(lut, sparse)
        arrays = {"d": dense.reshape(nb, batch, *dense.shape[1:]),
                  "cold": cold.reshape(nb, batch, -1),
                  "hot": hot_idx.reshape(nb, batch, -1)}
        if S > 1:           # this rank's block of each batch
            arrays = {k: self._rank_block(v, v.dtype, axis=1)
                      for k, v in arrays.items()}
        buf, layout = self._to_device(arrays, nb)
        p = torch.empty((nb, batch // S), dtype=torch.float32,
                        device=self.device)
        for i in range(nb):
            self._run("fae_eval", self._fae_eval_body, state,
                      (buf[i], layout), out=p[i])
        if S > 1:           # [S, nb, b] -> the batches' sample order
            self._check_eval_overflow()
            p = self.comm.all_gather(p).permute(1, 0, 2)
        y_score = p.reshape(-1).cpu().numpy()
        return {"auc": M.auc_score(y_true, y_score),
                "acc": M.accuracy(y_true, y_score)}
