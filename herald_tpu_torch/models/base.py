"""Model definition API (port of `herald_tpu/models/base.py`).

A model is a pair of plain functions over a flat dict of tensors: the
engine owns the embedding table and hands the tower the looked-up
activations `emb [B, F, W]` plus the dense features; `apply` returns
logits [B]. The registry holds every model of the JAX package, the
four `fae_*` aliases (`models/__init__.py`) and one model of the port's
own, the multi-hot `dlrm_dcnv2_criteo1tb` (`models/dlrm.py`). A model
with a Megatron tower (wdl, dfm, dcn, emb_sum_wdl and their aliases) also
carries `tp_plan`, which shards each tower param over the mp group, and
`apply_tp`, the tower over those shards (`parallel/tp.py`), as in the
JAX package (`base.py:71-79`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from herald_tpu_torch.data.datasets import DatasetSpec


def normal(gen: torch.Generator, shape, stddev=0.01,
           dtype=torch.float32) -> torch.Tensor:
    """stddev * N(0, 1) on the generator's device."""
    return stddev * torch.randn(shape, generator=gen, dtype=dtype,
                                device=gen.device)


def mlp_init(gen: torch.Generator, sizes, stddev=0.01, bias=False,
             prefix="W") -> Dict[str, torch.Tensor]:
    """An MLP as a dict {W1..Wn[, b1..bn]} like the reference builders."""
    params = {}
    for i, (m, n) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"{prefix}{i + 1}"] = normal(gen, (m, n), stddev)
        if bias:
            params[f"b{i + 1}"] = torch.zeros((n,), dtype=torch.float32,
                                              device=gen.device)
    return params


def mlp_apply(params, x, n_layers, relu_last=False, prefix="W"):
    for i in range(n_layers):
        x = x @ params[f"{prefix}{i + 1}"]
        if f"b{i + 1}" in params:
            x = x + params[f"b{i + 1}"]
        if i < n_layers - 1 or relu_last:
            x = torch.relu(x)
    return x


@dataclasses.dataclass(frozen=True)
class ModelDef:
    """A CTR model: embedding-table geometry + dense tower functions."""

    name: str
    spec: DatasetSpec
    # table width given the configured embedding dim (DeepFM fuses its
    # 1st- and 2nd-order tables into one [rows, D+1] table)
    emb_width: Callable[[int], int]
    init_dense: Callable[..., Dict]       # (gen, emb_dim) -> params
    apply: Callable[..., torch.Tensor]    # (params, emb, dense) -> logits [B]
    default_lr: float = 0.01
    num_embed_rows: Optional[int] = None  # override spec.num_embed_rows
    # "engine" (the default) or "fae": the launcher trains the model on
    # the hot/cold FAE engine (train/fae.py), as if given --fae
    train_engine: str = "engine"
    # tensor-parallel tower (cfg.mp_shards > 1): `tp_plan` maps a param
    # name to "col" | "row" | "rep" (column-sharded, row-sharded or
    # replicated over the mp group; absent names are "rep"), and
    # `apply_tp(params_local, emb, dense, mp_comm) -> logits` is the
    # Megatron form of `apply` over those shards
    tp_plan: Optional[Dict[str, str]] = None
    apply_tp: Optional[Callable] = None
    # multi-hot models (a `MultiHotSpec`): `bags` gives the size of each
    # bag, contiguous over the spec's positions, and `apply_pooled(params,
    # pooled [B, bags, W], dense) -> logits` the tower over each bag's sum
    # of rows, which the one-rank engine reads through K1's pooled form;
    # `apply` pools [B, P, W] itself and calls it
    bags: Optional[Tuple[int, ...]] = None
    apply_pooled: Optional[Callable] = None

    @property
    def table_rows(self) -> int:
        return self.num_embed_rows or self.spec.num_embed_rows


_REGISTRY: Dict[str, ModelDef] = {}


def register(model: ModelDef) -> ModelDef:
    _REGISTRY[model.name] = model
    return model


def get_model(name: str) -> ModelDef:
    # late import so model modules self-register
    import herald_tpu_torch.models  # noqa: F401
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_models():
    import herald_tpu_torch.models  # noqa: F401
    return sorted(_REGISTRY)


def bce_with_logits(logits, labels):
    """Stable sigmoid+BCE, mean-reduced."""
    logits = logits.reshape(-1)
    labels = labels.reshape(-1).to(logits.dtype)
    # log(1+exp(-|x|)) + max(x,0) - x*y
    loss = torch.clamp(logits, min=0) - logits * labels + \
        torch.log1p(torch.exp(-torch.abs(logits)))
    return loss.mean()
