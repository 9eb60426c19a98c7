"""Shallow sparse models and two sum-pooled variants (port of
`herald_tpu/models/linear.py`): sparse LR (`dfmslr_avazu`), pure FM
(`dfmsfm_criteosearch`), sum-pooled DeepFM (`emb_sum_dfm_avazu`) and
sum-pooled DCN (`emb_sum_dcn_criteosearch`). The FM 2nd-order terms run
through K5 (`models/dfm.py` `fm_terms`)."""

from __future__ import annotations

import torch

from herald_tpu_torch.data.datasets import DATASETS
from herald_tpu_torch.models.base import (ModelDef, mlp_apply, mlp_init,
                                          normal, register)
from herald_tpu_torch.models.dcn import cross_init, cross_layers
from herald_tpu_torch.models.dfm import fm_terms


def _lr_init(nd, stddev):
    def init_dense(gen, emb_dim):
        return {"FM_W": normal(gen, (nd, 1), stddev),
                "bias": torch.full((1,), 0.01, dtype=torch.float32,
                                   device=gen.device)}
    return init_dense


def _make_slr(name, spec, stddev=0.01):
    """Sparse LR: logits = dense @ W + sum(E1[ids]) + bias, over a table
    of width 1 (1st-order weights only)."""

    def apply(params, emb, dense):
        return ((dense @ params["FM_W"]).reshape(-1)
                + emb[:, :, 0].sum(dim=1) + params["bias"][0])

    return register(ModelDef(
        name=name, spec=spec, emb_width=lambda d: 1,
        init_dense=_lr_init(spec.num_dense, stddev), apply=apply,
        default_lr=0.001))


def _make_sfm(name, spec, stddev=0.01):
    """Pure FM: 1st + 2nd order over the fused [rows, D+1] table."""

    def apply(params, emb, dense):
        y1, y2, _ = fm_terms(params, emb, dense)
        return y1 + y2 + params["bias"][0]

    return register(ModelDef(
        name=name, spec=spec, emb_width=lambda d: d + 1,
        init_dense=_lr_init(spec.num_dense, stddev), apply=apply,
        default_lr=0.001))


dfmslr_avazu = _make_slr("dfmslr_avazu", DATASETS["avazu"])
dfmsfm_criteosearch = _make_sfm("dfmsfm_criteosearch",
                                DATASETS["criteosearch"])


def _make_emb_sum_dfm(name, spec, widths, stddev=0.01):
    """Sum-pooled DeepFM: the FM terms as usual, the DNN over the
    sum-pooled 2nd-order embedding instead of the flattened [F*D]."""

    def init_dense(gen, emb_dim):
        params = mlp_init(gen, [emb_dim] + widths, stddev=stddev)
        params["FM_W"] = normal(gen, (spec.num_dense, 1), stddev)
        return params

    def apply(params, emb, dense):
        y1, y2, second = fm_terms(params, emb, dense)
        h = mlp_apply(params, second.sum(dim=1), len(widths))   # sum-pooled
        return y1 + y2 + h.reshape(-1)

    return register(ModelDef(
        name=name, spec=spec, emb_width=lambda d: d + 1,
        init_dense=init_dense, apply=apply, default_lr=0.01))


def _make_emb_sum_dcn(name, spec):
    """Sum-pooled DCN: cross layers and MLP over [sum_f emb ; dense]."""

    def init_dense(gen, emb_dim):
        return cross_init(gen, emb_dim + spec.num_dense)

    def apply(params, emb, dense):
        return cross_layers(params, torch.cat([emb.sum(dim=1), dense],
                                              dim=1))

    return register(ModelDef(
        name=name, spec=spec, emb_width=lambda d: d,
        init_dense=init_dense, apply=apply, default_lr=0.003))


emb_sum_dfm_avazu = _make_emb_sum_dfm("emb_sum_dfm_avazu",
                                      DATASETS["avazu"], [64, 32, 1])
emb_sum_dcn_criteosearch = _make_emb_sum_dcn("emb_sum_dcn_criteosearch",
                                             DATASETS["criteosearch"])
