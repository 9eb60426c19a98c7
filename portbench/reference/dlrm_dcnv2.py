"""DLRM-DCNv2, the recommendation model of MLPerf Training (v3.0 on), over
multi-hot Criteo 1TB, as the MLCommons reference builds it
(github.com/mlcommons/training, `recommendation_v2/torchrec_dlrm`, on
TorchRec's `DLRM_DCN`, `InteractionDCNArch` and `LowRankCrossNet`; the
DCN-V2 paper, arXiv:2008.13535):

- each of the 26 tables is read through a bag of ids (`MULTI_HOT`, 214 a
  sample, the bags contiguous in table order), sum-pooled;
- bottom MLP over the 13 dense features, 13 -> 512 -> 256 -> D, a bias
  and a ReLU after every layer;
- x0 = [bottom ; the 26 pooled bags], [B, 27 * D]; three low-rank cross
  layers of rank 512, x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l, V_l
  without a bias;
- top MLP 27 * D -> 1024 -> 1024 -> 512 -> 256 with biases and ReLU, then
  a linear 256 -> 1 with a bias: the logit.

Plain PyTorch, f32 unless `mm` says otherwise; weights are (in, out).
Departures from TorchRec: weights are drawn at std 1/sqrt(fan_in) and
biases at 0.01 (`init_std`), where TorchRec draws `nn.Linear`'s uniform
default and the cross net's Xavier normal with zero biases; the table is
one global id space with each table's ids offset into it, where TorchRec
keeps 26 tables; the training reference (`train.py`) is SGD, where the
source trains with Adagrad.
"""

import math

import torch

# the source's --multi_hot_sizes
MULTI_HOT = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
             100, 27, 10, 3, 1, 1)


def _mlp_shapes(prefix: str, sizes) -> dict:
    out = {}
    for i, (m, n) in enumerate(zip(sizes[:-1], sizes[1:])):
        out[f"{prefix}_W{i + 1}"] = (m, n)
        out[f"{prefix}_b{i + 1}"] = (n,)
    return out


def shapes(cfg: dict) -> dict:
    t, D = cfg["tower"], cfg["embedding_dim"]
    x_dim = (len(cfg["multi_hot_sizes"]) + 1) * D
    out = _mlp_shapes("bot", [cfg["num_dense"], *t["bottom"]])
    for i in range(1, t["cross_layers"] + 1):
        out[f"cross_V{i}"] = (x_dim, t["cross_rank"])
        out[f"cross_W{i}"] = (t["cross_rank"], x_dim)
        out[f"cross_b{i}"] = (x_dim,)
    out.update(_mlp_shapes("top", [x_dim, *t["top"]]))
    return out


def init_std(cfg: dict) -> dict:
    """{name: the std each leaf is drawn at}: 1/sqrt(fan_in) for a weight,
    0.01 for a bias."""
    return {k: 1.0 / math.sqrt(s[0]) if len(s) == 2 else 0.01
            for k, s in shapes(cfg).items()}


def width(cfg: dict) -> int:
    return cfg["embedding_dim"]


def _mlp(p: dict, prefix: str, x, mm, relu_last: bool):
    n = sum(1 for k in p if k.startswith(f"{prefix}_W"))
    for i in range(1, n + 1):
        x = mm(x, p[f"{prefix}_W{i}"]) + p[f"{prefix}_b{i}"]
        if i < n or relu_last:
            x = torch.relu(x)
    return x


def logits(p: dict, emb: torch.Tensor, dense: torch.Tensor, mm,
           bags=MULTI_HOT) -> torch.Tensor:
    """emb [B, P, D] f32 (each position's row, the bags contiguous), dense
    [B, 13] -> logits [B]."""
    B = emb.shape[0]
    if emb.shape[1] != sum(bags):
        raise ValueError(f"{emb.shape[1]} positions for bags summing to "
                         f"{sum(bags)}")
    ends = torch.tensor(bags).cumsum(0).tolist()
    pooled = torch.stack([emb[:, e - b:e].sum(dim=1)
                          for b, e in zip(bags, ends)], dim=1)
    bottom = _mlp(p, "bot", dense, mm, True)
    x0 = torch.cat([bottom.unsqueeze(1), pooled], dim=1).reshape(B, -1)
    x = x0
    n = sum(1 for k in p if k.startswith("cross_V"))
    for i in range(1, n + 1):
        x = x0 * (mm(mm(x, p[f"cross_V{i}"]), p[f"cross_W{i}"])
                  + p[f"cross_b{i}"]) + x
    return _mlp(p, "top", x, mm, False).reshape(-1)


def flops(cfg: dict, batch: int, train: bool) -> float:
    """Multiply-adds of the tower's products, counted twice, a batch: the
    forward, and with `train` the backward's weight gradients and input
    gradients (none for the dense features, the bottom's first layer)."""
    gemm = [(k, m, n) for k, s in shapes(cfg).items() if len(s) == 2
            for m, n in (s,)]
    fwd = sum(2.0 * batch * m * n for _, m, n in gemm)
    if not train:
        return fwd
    dx = sum(2.0 * batch * m * n for k, m, n in gemm if k != "bot_W1")
    return fwd + fwd + dx
