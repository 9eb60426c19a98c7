"""FAE baseline: hot/cold split embeddings (port of
`herald_tpu/train/fae.py`, one device).

The most frequent ids ("hot", 1% of the rows by default) live in a dense
block `hot_table` [H, W] trained beside the tower; the other ("cold") ids
go through the plain engine's table. `build_hot_lut` profiles the training
ids once and maps each hot id to its row of the block.

A step on the card:
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
a CUDA graph (`train/graphs.py`). Over one rank `comm_mode="hybrid"` runs
it as it is; its row-sharded form over several ranks is ROADMAP queue 1,
item 8, and the engine refuses it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from herald_tpu_torch.config import HeraldConfig
from herald_tpu_torch.models.base import ModelDef
from herald_tpu_torch.ops.embedding import unique_static
from herald_tpu_torch.ops.kernels import (hot_onehot_gather_add_,
                                          hot_onehot_push)
from herald_tpu_torch.train.engine import Engine
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
        super().__init__(cfg, model=model, table_rows=table_rows,
                         device=device, cuda_graphs=cuda_graphs)
        if self.num_shards > 1:
            raise NotImplementedError(
                "the FAE engine over several ranks is not ported to "
                "herald_tpu_torch yet (ROADMAP queue 1, item 8)")
        # of the logical rows, not the padded ones
        self.num_hot = num_hot or max(1, int(self.num_rows * hot_rate))

    def init_fae_state(self, seed: Optional[int] = None) -> FaeTrainState:
        """The base state from `seed`, then the hot block ~ 0.01 * N(0, 1)
        in f32 from seed + 7, cast to the table dtype, and its zero f32
        slots."""
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
    def _fae_read(self, state: FaeTrainState, ids, hot_idx):
        """ids (cold, -1 where hot), hot_idx (hot row, -1 where cold)
        [B, F] -> f32 [B, F, W]: one K1 read by position, then one K4 add
        of the hot rows in place."""
        emb = self._read(state.table, ids)
        hot_onehot_gather_add_(emb.view(-1, self.width), state.hot_table,
                               hot_idx.reshape(-1))
        return emb

    def _apply_hot_grads(self, hot_table, hot_slots, step, g_hot):
        """The embedding optimizer over every row of the hot block, in f32
        (under adam every row moves each step); the rows go back into the
        block, in the table dtype, in place."""
        rows, slots = self.embed_opt.apply_rows(
            hot_table.float(), g_hot, hot_slots, step, lr=self._elr_fn(step))
        return hot_table.copy_(rows), slots

    def _fae_step_body(self, state: FaeTrainState, a):
        """One step on the inputs `a` ("d", "cold", "hot", "y"): (state,
        loss)."""
        step = state.step.add_(1)
        ids, hot_idx = a["cold"], a["hot"]
        flat = ids.reshape(-1)
        U = flat.numel()
        uniq, inv = unique_static(flat, U)
        inv = torch.where(flat >= 0, inv, U)
        emb = self._fae_read(state, ids, hot_idx)
        loss, dgrads, emb_grad = self._loss_and_grads(state.dense, emb,
                                                      a["d"], a["y"])
        dense, dense_slots = self.dense_opt.apply_dense(
            state.dense, dgrads, state.dense_slots, step,
            lr=self._lr_fn(step), in_place=True)
        table, table_slots = self._apply_sparse_grads(
            state.table, state.table_slots, step, uniq, inv, emb_grad)
        g_hot = hot_onehot_push(hot_idx.reshape(-1),
                                emb_grad.reshape(-1, self.width),
                                self.num_hot)
        hot_table, hot_slots = self._apply_hot_grads(
            state.hot_table, state.hot_slots, step, g_hot)
        new_state = FaeTrainState(
            table=table, table_slots=table_slots, dense=dense,
            dense_slots=dense_slots, step=step, hot_table=hot_table,
            hot_slots=hot_slots)
        return new_state, loss

    def _fae_eval_body(self, state: FaeTrainState, a):
        logits = self.model.apply(state.dense,
                                  self._fae_read(state, a["cold"], a["hot"]),
                                  a["d"])
        return state, torch.sigmoid(logits)

    # ------------------------------------------------------------------
    def split_batch(self, lut: np.ndarray, sparse_ids: np.ndarray):
        """Host split: (cold ids with -1 at hot positions, hot_idx)."""
        hot_idx = lut[sparse_ids]
        cold = np.where(hot_idx >= 0, -1, sparse_ids)
        return cold.astype(np.int32), hot_idx.astype(np.int32)

    def train_step_fae(self, state: FaeTrainState, lut, dense_x, sparse_ids,
                       labels):
        """One step on one batch: (state, {"loss", "overflow"}). The batch
        is split on the host and its four arrays go to the card in one
        copy; the state handed in is consumed."""
        cold, hot_idx = self.split_batch(lut, np.asarray(sparse_ids))
        state, loss = self._run("fae", self._fae_step_body, state,
                                self._host_feed({
                                    "d": np.asarray(dense_x, np.float32),
                                    "cold": cold, "hot": hot_idx,
                                    "y": np.asarray(labels, np.float32)}))
        return state, {"loss": loss, "overflow": self._zero}

    @torch.inference_mode()
    def evaluate_fae(self, state: FaeTrainState, lut, dense_x, sparse_ids,
                     labels, batch: Optional[int] = None
                     ) -> Dict[str, float]:
        """AUC and accuracy over the whole batches only: a tail shorter
        than `batch` is not scored, as in JAX (`fae.py:230`). The batches
        go to the card in one copy and come back in one."""
        batch = batch or self.cfg.batch_size
        nb = len(sparse_ids) // batch
        y_true = np.asarray(labels).reshape(-1)[: nb * batch]
        if nb == 0:
            return {"auc": M.auc_score(y_true, np.zeros(0)),
                    "acc": M.accuracy(y_true, np.zeros(0))}
        n = nb * batch
        sparse = np.asarray(sparse_ids)[:n]
        dense = np.asarray(dense_x, np.float32)[:n]
        cold, hot_idx = self.split_batch(lut, sparse)
        buf, layout = self._to_device({
            "d": dense.reshape(nb, batch, *dense.shape[1:]),
            "cold": cold.reshape(nb, batch, -1),
            "hot": hot_idx.reshape(nb, batch, -1)}, nb)
        p = torch.empty((nb, batch), dtype=torch.float32, device=self.device)
        for i in range(nb):
            self._run("fae_eval", self._fae_eval_body, state,
                      (buf[i], layout), out=p[i])
        y_score = p.reshape(-1).cpu().numpy()
        return {"auc": M.auc_score(y_true, y_score),
                "acc": M.accuracy(y_true, y_score)}
