"""DLRM-DCNv2, the recommendation model of MLPerf Training (v3.0 on), over
multi-hot Criteo 1TB: `dlrm_dcnv2_criteo1tb`. A model of the port's own;
the JAX package has none like it.

Sources: the MLCommons reference (github.com/mlcommons/training,
`recommendation_v2/torchrec_dlrm`), TorchRec's `DLRM_DCN` and
`InteractionDCNArch` (`torchrec/models/dlrm.py`) and `LowRankCrossNet`
(`torchrec/modules/crossnet.py`), and the DCN-V2 paper (arXiv:2008.13535).

- Embeddings: the 26 tables of `data.datasets.CRITEO1TB_TABLE_SIZES`,
  one global id space; each sample reads a bag of ids from each table
  (sizes `CRITEO1TB_BAG_SIZES`, 214 ids, the bags contiguous), and a bag
  is the sum of its rows.
- Bottom MLP: 13 -> 512 -> 256 -> D with biases and a ReLU after every
  layer (the source's D is 128, the embedding dim).
- Interaction: x0 = [bottom ; the 26 pooled bags], flattened to 27 * D
  columns, then three low-rank cross layers of rank 512:
  x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l, V_l without a bias.
- Top MLP: 27 * D -> 1024 -> 1024 -> 512 -> 256 with biases and ReLU,
  then a linear 256 -> 1 with a bias.

Weights are (in, out) and drawn at std 1/sqrt(fan_in), biases at 0.01
(the source draws TorchRec's defaults). The one-rank engine reads the
bags through K1's pooled form and calls `apply_pooled`; `apply` pools
[B, 214, D] itself through the plain pooled read's `pool_bags`, for any
engine that hands a tower its rows by position.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from herald_tpu_torch.data.datasets import PORT_DATASETS, MultiHotSpec
from herald_tpu_torch.models.base import ModelDef, normal, register
from herald_tpu_torch.ops.kernels.gather import pool_bags

BOTTOM = (512, 256)       # then the embedding dim
TOP = (1024, 1024, 512, 256, 1)
NUM_CROSS = 3
CROSS_RANK = 512


def _layers(prefix, sizes):
    return [(f"{prefix}_W{i + 1}", f"{prefix}_b{i + 1}", m, n)
            for i, (m, n) in enumerate(zip(sizes[:-1], sizes[1:]))]


def shapes(num_dense: int, num_tables: int, emb_dim: int) -> dict:
    """{name: shape} of the tower, in its order."""
    x_dim = (num_tables + 1) * emb_dim
    out = {}
    for w, b, m, n in _layers("bot", (num_dense, *BOTTOM, emb_dim)):
        out[w], out[b] = (m, n), (n,)
    for i in range(1, NUM_CROSS + 1):
        out[f"cross_V{i}"] = (x_dim, CROSS_RANK)
        out[f"cross_W{i}"] = (CROSS_RANK, x_dim)
        out[f"cross_b{i}"] = (x_dim,)
    for w, b, m, n in _layers("top", (x_dim, *TOP)):
        out[w], out[b] = (m, n), (n,)
    return out


def _mlp(params, prefix, x, n_layers, relu_last):
    for i in range(1, n_layers + 1):
        x = x @ params[f"{prefix}_W{i}"] + params[f"{prefix}_b{i}"]
        if i < n_layers or relu_last:
            x = torch.relu(x)
    return x


def tower(params, pooled: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
    """Logits [B] from the pooled bags [B, T, D] and dense [B, ND]."""
    B = pooled.shape[0]
    bottom = _mlp(params, "bot", dense, len(BOTTOM) + 1, True)
    x0 = torch.cat([bottom.unsqueeze(1), pooled], dim=1).reshape(B, -1)
    x = x0
    for i in range(1, NUM_CROSS + 1):
        x = x0 * ((x @ params[f"cross_V{i}"]) @ params[f"cross_W{i}"]
                  + params[f"cross_b{i}"]) + x
    return _mlp(params, "top", x, len(TOP), False).reshape(-1)


def make_dlrm(name: str, spec: MultiHotSpec) -> ModelDef:
    """DLRM-DCNv2 over a multi-hot spec (unregistered: `register` it)."""
    bags = tuple(spec.bag_sizes)
    offsets = np.concatenate([[0], np.cumsum(bags)]).tolist()

    def init_dense(gen, emb_dim):
        params = {}
        for k, s in shapes(spec.num_dense, len(bags), emb_dim).items():
            std = 0.01 if len(s) == 1 else 1.0 / math.sqrt(s[0])
            params[k] = normal(gen, s, std)
        return params

    def apply(params, emb, dense):
        return tower(params, pool_bags(emb, offsets), dense)

    return ModelDef(name=name, spec=spec, emb_width=lambda d: d,
                    init_dense=init_dense, apply=apply, bags=bags,
                    apply_pooled=tower)


dlrm_dcnv2_criteo1tb = register(make_dlrm("dlrm_dcnv2_criteo1tb",
                                          PORT_DATASETS["criteo1tb"]))
