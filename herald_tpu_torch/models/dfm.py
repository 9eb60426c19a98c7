"""DeepFM towers (port of `herald_tpu/models/dfm.py`): `dfm_criteo`,
`dfm_avazu`, `dfm_criteosearch`.

The 1st-order [rows, 1] and 2nd-order [rows, D] tables of the reference
are fused into one [rows, D+1] table (column 0 = the 1st-order weight), as
in the JAX package. The FM 2nd-order term runs through K5
(`ops/kernels/fm.py`, `FMSecondOrder`) on the view `emb[:, :, 1:]`, where
JAX computes it inline. Under tensor parallelism the FM terms are
replicated and the DNN is W1 col / W2 row / W3 row (JAX `dfm.py:55-75`).
"""

from __future__ import annotations

import torch

from herald_tpu_torch.data.datasets import DATASETS
from herald_tpu_torch.models.base import (ModelDef, mlp_apply, mlp_init,
                                          normal, register)
from herald_tpu_torch.ops.kernels.fm import FMSecondOrder
from herald_tpu_torch.parallel import tp

_TOWERS = {
    # dataset -> (mlp widths, stddev)
    "criteo": ([256, 256, 1], 0.01),
    "avazu": ([64, 32, 1], 0.01),
    "criteosearch": ([256, 256, 1], 0.001),
}


def fm_terms(params, emb, dense):
    """(y1, y2, second): the FM 1st-order term (dense linear part plus the
    1st-order weights), the 2nd-order term through K5, and the 2nd-order
    view [B, F, D] of the fused activations."""
    first = emb[:, :, 0]                       # [B, F] 1st-order weights
    second = emb[:, :, 1:]                     # [B, F, D], a view
    y1 = (dense @ params["FM_W"]).reshape(-1) + first.sum(dim=1)
    return y1, FMSecondOrder.apply(second), second


def _make_dfm(name, spec, widths, stddev):
    F, ND = spec.num_sparse, spec.num_dense

    def init_dense(gen, emb_dim):
        params = mlp_init(gen, [F * emb_dim] + widths, stddev=stddev)
        params["FM_W"] = normal(gen, (ND, 1), stddev)
        return params

    def apply(params, emb, dense):
        y1, y2, second = fm_terms(params, emb, dense)
        # DNN over the flattened 2nd-order embeddings
        h = mlp_apply(params, second.reshape(emb.shape[0], -1), len(widths))
        return y1 + y2 + h.reshape(-1)

    def apply_tp(params, emb, dense, comm):
        y1, y2, second = fm_terms(params, emb, dense)
        h = torch.relu(second.reshape(emb.shape[0], -1) @ params["W1"])
        h = torch.relu(tp.row_parallel_sharded(h, params["W2"], comm))
        h = tp.row_parallel(h, params["W3"], comm)
        return y1 + y2 + h.reshape(-1)

    return register(ModelDef(
        name=name, spec=spec, emb_width=lambda d: d + 1,
        init_dense=init_dense, apply=apply, default_lr=0.01,
        tp_plan={"W1": "col", "W2": "row", "W3": "row"},
        apply_tp=apply_tp))


dfm_criteo = _make_dfm("dfm_criteo", DATASETS["criteo"], *_TOWERS["criteo"])
dfm_avazu = _make_dfm("dfm_avazu", DATASETS["avazu"], *_TOWERS["avazu"])
dfm_criteosearch = _make_dfm(
    "dfm_criteosearch", DATASETS["criteosearch"], *_TOWERS["criteosearch"])
