"""Wide & Deep over Criteo as Hetu's `examples/ctr` builds it: the dense
features through a 3-layer MLP (relu after the first two), its output
concatenated with the flattened sparse embeddings, one linear head, no
biases. Plain PyTorch, f32 unless `mm` says otherwise."""

import torch


def shapes(cfg: dict) -> dict:
    F, D, ND = cfg["num_sparse"], cfg["embedding_dim"], cfg["num_dense"]
    w = cfg["tower"]["widths"]
    return {"W1": (ND, w[0]), "W2": (w[0], w[1]), "W3": (w[1], w[2]),
            "W4": (w[2] + F * D, 1)}


def width(cfg: dict) -> int:
    """Columns of a table row."""
    return cfg["embedding_dim"]


def logits(p: dict, emb: torch.Tensor, dense: torch.Tensor,
           mm) -> torch.Tensor:
    """emb [B, F, D] f32, dense [B, ND] -> logits [B]."""
    B = emb.shape[0]
    h = torch.relu(mm(dense, p["W1"]))
    h = torch.relu(mm(h, p["W2"]))
    h = mm(h, p["W3"])
    return mm(torch.cat([emb.reshape(B, -1), h], dim=1), p["W4"]).reshape(-1)


def flops(cfg: dict, batch: int, train: bool) -> float:
    """Multiply-adds of the tower's products, counted twice, a batch: the
    forward, and with `train` the backward's weight and input gradients
    (no input gradient of the dense features)."""
    s = shapes(cfg)
    fwd = sum(2.0 * batch * m * n for m, n in s.values())
    if not train:
        return fwd
    dx = sum(2.0 * batch * m * n for k, (m, n) in s.items() if k != "W1")
    return fwd + fwd + dx
