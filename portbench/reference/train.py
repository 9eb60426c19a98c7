"""Plain SGD over a CTR model: the reference of the training cells.

A step reads the batch's rows from a table stored in the configuration's
table dtype, runs the model's tower in f32 (or in the precision `mm`
gives), takes the mean binary cross-entropy, and moves every parameter
by -lr times its gradient: the tower in f32, each table row once by the
sum of its positions' gradients, computed in f32 and stored back in the
table dtype. Only the rows the steps touch are held.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch
import torch.nn.functional as fnn


class Batch(NamedTuple):
    dense: torch.Tensor     # f32 [B, ND]
    ids: torch.Tensor       # int [B, F]
    labels: torch.Tensor    # f32 [B, 1]


class State(NamedTuple):
    """The tower and the rows of `ids` (sorted, distinct) in the table
    dtype."""
    tower: Dict[str, torch.Tensor]
    ids: torch.Tensor
    rows: torch.Tensor


def loss_and_grads(model, tower, emb, batch: Batch, mm, keep=None):
    """(loss, {name: grad}, grad of emb) of the mean BCE over the batch,
    or over its rows `keep` (a fault the checks must catch)."""
    params = {k: v.detach().requires_grad_(True) for k, v in tower.items()}
    emb = emb.detach().requires_grad_(True)
    with torch.enable_grad():
        logit = model.logits(params, emb, batch.dense, mm)
        y = batch.labels.reshape(-1)
        if keep is not None:
            logit, y = logit[keep], y[keep]
        loss = fnn.binary_cross_entropy_with_logits(logit, y)
        grads = torch.autograd.grad(loss, [*params.values(), emb])
    return loss.detach(), dict(zip(params, grads[:-1])), grads[-1]


def step(model, state: State, batch: Batch, lr: float, mm,
         half_batch: bool = False):
    """One SGD step: (new state, loss). `half_batch` leaves out the second
    half of the batch and takes the mean over the rest."""
    B, F = batch.ids.shape
    pos = torch.searchsorted(state.ids, batch.ids.reshape(-1).long())
    emb = state.rows[pos].to(torch.float32).reshape(B, F, -1)
    keep = torch.arange(B // 2, device=emb.device) if half_batch else None
    loss, grads, g_emb = loss_and_grads(model, state.tower, emb, batch, mm,
                                        keep)
    g_rows = torch.zeros(state.rows.shape, dtype=torch.float32,
                         device=emb.device).index_add_(
        0, pos, g_emb.reshape(B * F, -1))
    touched = torch.unique(pos)
    rows = state.rows.clone()
    rows[touched] = (state.rows[touched].to(torch.float32)
                     - lr * g_rows[touched]).to(state.rows.dtype)
    tower = {k: v - lr * grads[k] for k, v in state.tower.items()}
    return State(tower, state.ids, rows), loss


def run(model, state: State, batches: List[Batch], lr: float, mm,
        half_batch: bool = False):
    """The states after each step and the losses."""
    states, losses = [], []
    for b in batches:
        state, loss = step(model, state, b, lr, mm, half_batch)
        states.append(state)
        losses.append(float(loss))
    return states, losses
