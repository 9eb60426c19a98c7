"""Deep & Cross Network towers (port of `herald_tpu/models/dcn.py`):
`dcn_criteo`, `dcn_avazu`, `dcn_criteosearch`. The input is x0 =
[flattened embeddings ; dense features]; three cross layers compute
x_{l+1} = x0 * (x_l w) + x_l + b beside a 3-layer 256-wide MLP over x0,
and one linear head reads [x_3 ; h]. Under tensor parallelism the cross
layers and the head W4 are replicated and the MLP is W1 col / W2 row /
W3 col (JAX `dcn.py:47-70`: the head's input width is odd)."""

from __future__ import annotations

import torch

from herald_tpu_torch.data.datasets import DATASETS
from herald_tpu_torch.models.base import ModelDef, mlp_init, normal, register
from herald_tpu_torch.parallel import tp

NUM_CROSS = 3


def cross_init(gen, x_dim):
    """The MLP, the head and the cross weights over an input of x_dim."""
    params = mlp_init(gen, [x_dim, 256, 256, 256], stddev=0.01)
    params["W4"] = normal(gen, (256 + x_dim, 1), 0.01)
    for i in range(NUM_CROSS):
        params[f"cross_w{i + 1}"] = normal(gen, (x_dim, 1), 0.01)
        params[f"cross_b{i + 1}"] = normal(gen, (x_dim,), 0.01)
    return params


def cross_layers(params, x0, comm=None):
    """Logits [B] of the cross network and the MLP over x0 [B, x_dim];
    with an mp `comm` the MLP's params are its tp_plan shards."""
    x = x0
    for i in range(NUM_CROSS):
        xw = x @ params[f"cross_w{i + 1}"]          # [B, 1]
        x = x0 * xw + x + params[f"cross_b{i + 1}"]
    h = torch.relu(x0 @ params["W1"])
    h = torch.relu(tp.row_parallel_sharded(h, params["W2"], comm))
    h = tp.gather_cols(h @ params["W3"], comm)
    return (torch.cat([x, h], dim=1) @ params["W4"]).reshape(-1)


def _make_dcn(name, spec):
    F, ND = spec.num_sparse, spec.num_dense

    def init_dense(gen, emb_dim):
        return cross_init(gen, F * emb_dim + ND)

    def apply(params, emb, dense):
        return cross_layers(params, torch.cat(
            [emb.reshape(emb.shape[0], -1), dense], dim=1))

    def apply_tp(params, emb, dense, comm):
        return cross_layers(params, torch.cat(
            [emb.reshape(emb.shape[0], -1), dense], dim=1), comm)

    return register(ModelDef(
        name=name, spec=spec, emb_width=lambda d: d,
        init_dense=init_dense, apply=apply, default_lr=0.003,
        tp_plan={"W1": "col", "W2": "row", "W3": "col"},
        apply_tp=apply_tp))


dcn_criteo = _make_dcn("dcn_criteo", DATASETS["criteo"])
dcn_avazu = _make_dcn("dcn_avazu", DATASETS["avazu"])
dcn_criteosearch = _make_dcn("dcn_criteosearch", DATASETS["criteosearch"])
