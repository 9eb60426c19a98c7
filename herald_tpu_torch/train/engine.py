"""Engine, local mode (port of the eval half of `herald_tpu/train/engine.py`).

One device, the whole table on it. `predict` and `evaluate` run the JAX
engine's eval step: dedup the batch's ids, read the unique rows through K1
(`ops/kernels/gather.py`), widen them to f32, run the tower, sigmoid.
Training (the optimizers, the sparse update, kernels K2 and K3) comes in
the next slice of the port; the row-sharded hybrid exchange later.

Entry points run on the card unless the caller passes `device="cpu"`;
with no device given and no card present they raise.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from herald_tpu_torch.config import HeraldConfig
from herald_tpu_torch.models.base import ModelDef, get_model
from herald_tpu_torch.ops.kernels import embedding_gather
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


class Engine:
    """Scores batches with one model over a table on one device."""

    def __init__(self, cfg: HeraldConfig, model: Optional[ModelDef] = None,
                 table_rows: Optional[int] = None, device=None):
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
        # the JAX package pads the table to a multiple of 8 rows
        # (parallel/exchange.py:93-94); kept so checkpoints interchange
        self.padded_rows = -(-self.num_rows // 8) * 8

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Random state from a seed: table ~ 0.01 * N(0, 1), generated
        directly in `table_dtype` on the device (no f32 intermediate: at
        full width that would be 17 GB), then the tower. Optimizer slots
        come with the training slice."""
        seed = self.cfg.seed if seed is None else seed
        gen = torch.Generator(device=self.device).manual_seed(seed)
        table = torch.randn((self.padded_rows, self.width), generator=gen,
                            dtype=self.cfg.table_dtype, device=self.device)
        table.mul_(0.01)
        dense = self.model.init_dense(gen, self.cfg.embedding_dim)
        step = torch.zeros((), dtype=torch.int32, device=self.device)
        return TrainState(table=table, table_slots={}, dense=dense,
                          dense_slots={}, step=step)

    # ------------------------------------------------------------------
    def _gather_local(self, table, ids_flat):
        """Row read through K1; ids outside the table give zero rows (the
        JAX engine's `mode="fill"` read, `engine.py:292-293`)."""
        return embedding_gather(table, ids_flat)

    def _forward_embeddings(self, table, ids):
        """ids [B, F] -> emb [B, F, W]. Reads each distinct id once.
        `torch.unique` has a dynamic size, so it waits once per batch for
        the device; the JAX engine's static-size `jnp.unique` does not."""
        B, F = ids.shape
        uniq, inv = torch.unique(ids.reshape(-1), sorted=True,
                                 return_inverse=True)
        emb_uniq = self._gather_local(table, uniq)
        return emb_uniq[inv].reshape(B, F, self.width)

    def _eval_step_body(self, state: TrainState, dense_x, ids):
        emb = self._forward_embeddings(state.table, ids)
        logits = self.model.apply(state.dense, emb.to(torch.float32),
                                  dense_x)
        return torch.sigmoid(logits)

    def _put_batch(self, arr, dtype):
        return torch.as_tensor(np.asarray(arr, dtype), device=self.device)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def predict(self, state: TrainState, dense_x, sparse_ids
                ) -> torch.Tensor:
        """Probabilities [B] of one batch, on the engine's device."""
        d = self._put_batch(dense_x, np.float32)
        s = self._put_batch(sparse_ids, np.int32)
        return self._eval_step_body(state, d, s)

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
            dk = self._put_batch(d_all[b * rows:(b + 1) * rows], np.float32)
            sk = self._put_batch(s_all[b * rows:(b + 1) * rows], np.int32)
            p = [self._eval_step_body(state, dk[t * batch:(t + 1) * batch],
                                      sk[t * batch:(t + 1) * batch])
                 for t in range(T)]
            preds.append(torch.cat(p).cpu().numpy())
        y_score = np.concatenate(preds)[:n]
        y_true = np.asarray(labels).reshape(-1)[: len(y_score)]
        return {
            "auc": M.auc_score(y_true, y_score),
            "acc": M.accuracy(y_true, y_score),
        }
