"""Wide & Deep (WDL) towers (port of `herald_tpu/models/wdl.py`):
a 3-layer 256-wide MLP over the dense features, concatenated with the
flattened embeddings, then a single linear head."""

from __future__ import annotations

import torch

from herald_tpu_torch.data.datasets import DATASETS
from herald_tpu_torch.models.base import ModelDef, mlp_init, normal, register
from herald_tpu_torch.parallel import tp

# W1 col / W2 row / W3 col / W4 row, as the JAX towers shard them
WDL_TP_PLAN = {"W1": "col", "W2": "row", "W3": "col", "W4": "row"}


def wdl_tower_tp(params, head_in, dense, comm):
    """The wdl tower's Megatron pairing (JAX `wdl.py:36-47`): W1 col / W2
    row and its sum (the relu after the sum, as in `apply`), W3 col, the
    [B, 256] hidden gathered, W4 row and its sum over [head_in ; h]."""
    h = torch.relu(dense @ params["W1"])
    h = torch.relu(tp.row_parallel_sharded(h, params["W2"], comm))
    h = tp.gather_cols(h @ params["W3"], comm)
    y4 = torch.cat([head_in, h], dim=1)
    return tp.row_parallel(y4, params["W4"], comm).reshape(-1)


def _make_wdl(name, spec):
    F, ND = spec.num_sparse, spec.num_dense

    def init_dense(gen, emb_dim):
        params = mlp_init(gen, [ND, 256, 256, 256], stddev=0.01)
        params["W4"] = normal(gen, (256 + F * emb_dim, 1), 0.01)
        return params

    def apply(params, emb, dense):
        B = emb.shape[0]
        sparse_flat = emb.reshape(B, -1)
        h = torch.relu(dense @ params["W1"])
        h = torch.relu(h @ params["W2"])
        h = h @ params["W3"]
        y4 = torch.cat([sparse_flat, h], dim=1)
        return (y4 @ params["W4"]).reshape(-1)

    def apply_tp(params, emb, dense, comm):
        return wdl_tower_tp(params, emb.reshape(emb.shape[0], -1), dense,
                            comm)

    return register(ModelDef(
        name=name, spec=spec, emb_width=lambda d: d,
        init_dense=init_dense, apply=apply, tp_plan=WDL_TP_PLAN,
        apply_tp=apply_tp))


wdl_criteo = _make_wdl("wdl_criteo", DATASETS["criteo"])
wdl_avazu = _make_wdl("wdl_avazu", DATASETS["avazu"])
