"""NCF, Deep Crossing and the remaining towers (port of
`herald_tpu/models/misc.py`): `ncf_movie`, `emb_sum_ncf_movie`,
`dc_criteo`, `emb_sum_wdl_criteo`, `wdl_adult`."""

from __future__ import annotations

import torch

from herald_tpu_torch.data.datasets import DATASETS
from herald_tpu_torch.models.base import ModelDef, mlp_init, normal, register
from herald_tpu_torch.models.wdl import WDL_TP_PLAN, wdl_tower_tp

# ----------------------------------------------------------------------
# NCF (MovieLens): GMF + MLP towers over user/item embeddings. The table
# is emb_dim + L0//2 wide: the first emb_dim columns feed the matrix
# factorization, the rest the MLP.
# ----------------------------------------------------------------------
_NCF_LAYERS = [64, 32, 16, 8]


def _ncf_init(gen, emb_dim):
    L = _NCF_LAYERS
    return {
        "W1": normal(gen, (L[0], L[1]), 0.1),
        "W2": normal(gen, (L[1], L[2]), 0.1),
        "W3": normal(gen, (L[2], L[3]), 0.1),
        "W4": normal(gen, (emb_dim + L[3], 1), 0.1),
    }


def _ncf_apply(params, emb, dense):
    # emb: [B, 2, emb_dim + L0//2]; field 0 = user, field 1 = item; no
    # dense features
    emb_dim = emb.shape[-1] - _NCF_LAYERS[0] // 2
    user, item = emb[:, 0, :], emb[:, 1, :]
    mf = user[:, :emb_dim] * item[:, :emb_dim]
    mlp_in = torch.cat([user[:, emb_dim:], item[:, emb_dim:]], dim=1)
    h = torch.relu(mlp_in @ params["W1"])
    h = torch.relu(h @ params["W2"])
    h = torch.relu(h @ params["W3"])
    return (torch.cat([mf, h], dim=1) @ params["W4"]).reshape(-1)


def _make_ncf(name):
    return register(ModelDef(
        name=name, spec=DATASETS["movie"],
        emb_width=lambda d: d + _NCF_LAYERS[0] // 2,
        init_dense=_ncf_init, apply=_ncf_apply, default_lr=0.01))


ncf_movie = _make_ncf("ncf_movie")
# the reference's emb_sum_ncf_movie slices rather than sum-pools: the same
# tower under its own name, as in the JAX package
emb_sum_ncf_movie = _make_ncf("emb_sum_ncf_movie")


# ----------------------------------------------------------------------
# Deep Crossing (dc_criteo): 5 residual units over [emb ; dense].
# ----------------------------------------------------------------------
_DC_LAYERS = 5


def _dc_init(gen, emb_dim):
    spec = DATASETS["criteo"]
    x_dim = spec.num_sparse * emb_dim + spec.num_dense
    params = {}
    for i in range(_DC_LAYERS):
        params[f"res_w1_{i}"] = normal(gen, (x_dim, x_dim), 0.1)
        params[f"res_b1_{i}"] = normal(gen, (x_dim,), 0.1)
        params[f"res_w2_{i}"] = normal(gen, (x_dim, x_dim), 0.1)
        params[f"res_b2_{i}"] = normal(gen, (x_dim,), 0.1)
    params["W4"] = normal(gen, (x_dim, 1), 0.1)
    return params


def _dc_apply(params, emb, dense):
    x = torch.cat([emb.reshape(emb.shape[0], -1), dense], dim=1)
    for i in range(_DC_LAYERS):
        h = torch.relu(x @ params[f"res_w1_{i}"] + params[f"res_b1_{i}"])
        h = h @ params[f"res_w2_{i}"] + params[f"res_b2_{i}"]
        x = torch.relu(h + x)
    return (x @ params["W4"]).reshape(-1)


dc_criteo = register(ModelDef(
    name="dc_criteo", spec=DATASETS["criteo"], emb_width=lambda d: d,
    init_dense=_dc_init, apply=_dc_apply, default_lr=0.001))


# ----------------------------------------------------------------------
# emb_sum_wdl_criteo: the WDL tower with the embeddings sum-pooled over
# the fields before the head.
# ----------------------------------------------------------------------

def _make_emb_sum_wdl(name, spec):
    def init_dense(gen, emb_dim):
        params = mlp_init(gen, [spec.num_dense, 256, 256, 256], stddev=0.01)
        params["W4"] = normal(gen, (256 + emb_dim, 1), 0.01)
        return params

    def apply(params, emb, dense):
        pooled = emb.sum(dim=1)                  # [B, D]
        h = torch.relu(dense @ params["W1"])
        h = torch.relu(h @ params["W2"])
        h = h @ params["W3"]
        return (torch.cat([pooled, h], dim=1) @ params["W4"]).reshape(-1)

    def apply_tp(params, emb, dense, comm):
        # the wdl tower's pairing with the pooled embedding in the head
        return wdl_tower_tp(params, emb.sum(dim=1), dense, comm)

    return register(ModelDef(
        name=name, spec=spec, emb_width=lambda d: d,
        init_dense=init_dense, apply=apply, default_lr=0.01,
        tp_plan=WDL_TP_PLAN, apply_tp=apply_tp))


emb_sum_wdl_criteo = _make_emb_sum_wdl("emb_sum_wdl_criteo",
                                       DATASETS["criteo"])


# ----------------------------------------------------------------------
# Wide & Deep on census income (wdl_adult): 8 fields x 8-wide embeddings
# whatever the configured dim, deep tower 68 -> 50 -> 20, wide part = the
# 809 one-hot columns beside the deep output, into a 2-class head written
# as the logit difference z1 - z0. Dense layout: dense[:, :4] = the deep
# continuous features, dense[:, 4:] = the wide columns.
# ----------------------------------------------------------------------

def _adult_init(gen, emb_dim):
    return {
        "W": normal(gen, (809 + 20, 2), 0.1),
        "W1": normal(gen, (8 * 8 + 4, 50), 0.1),
        "b1": normal(gen, (50,), 0.1),
        "W2": normal(gen, (50, 20), 0.1),
        "b2": normal(gen, (20,), 0.1),
    }


def _adult_apply(params, emb, dense):
    x = torch.cat([emb[:, :, :8].reshape(emb.shape[0], -1), dense[:, :4]],
                  dim=1)
    h = torch.relu(x @ params["W1"] + params["b1"])
    h = torch.relu(h @ params["W2"] + params["b2"])
    z = torch.cat([dense[:, 4:], h], dim=1) @ params["W"]     # [B, 2]
    return z[:, 1] - z[:, 0]


wdl_adult = register(ModelDef(
    name="wdl_adult", spec=DATASETS["adult"], emb_width=lambda d: 8,
    init_dense=_adult_init, apply=_adult_apply, default_lr=5 / 128))
