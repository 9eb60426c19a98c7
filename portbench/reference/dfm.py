"""DeepFM over Criteo as Hetu's `examples/ctr` builds it, with its two
tables fused into one of D + 1 columns (column 0 the first-order weight):
y = dense . FM_W + sum_f w_f (first order) + 0.5 * sum_d ((sum_f v_fd)^2
- sum_f v_fd^2) (second order) + an MLP over the flattened second-order
embeddings (relu after all but the last layer, no biases). Plain
PyTorch, f32 unless `mm` says otherwise."""

import torch


def shapes(cfg: dict) -> dict:
    F, D, ND = cfg["num_sparse"], cfg["embedding_dim"], cfg["num_dense"]
    w = cfg["tower"]["widths"]
    dims = [F * D] + list(w)
    out = {f"W{i + 1}": (m, n) for i, (m, n) in enumerate(zip(dims[:-1],
                                                              dims[1:]))}
    out["FM_W"] = (ND, 1)
    return out


def width(cfg: dict) -> int:
    return cfg["embedding_dim"] + 1


def logits(p: dict, emb: torch.Tensor, dense: torch.Tensor,
           mm) -> torch.Tensor:
    """emb [B, F, D + 1] f32, dense [B, ND] -> logits [B]."""
    B = emb.shape[0]
    first, second = emb[:, :, 0], emb[:, :, 1:]
    y1 = mm(dense, p["FM_W"]).reshape(-1) + first.sum(dim=1)
    s = second.sum(dim=1)
    y2 = 0.5 * (s * s - (second * second).sum(dim=1)).sum(dim=1)
    h = second.reshape(B, -1)
    n = sum(1 for k in p if k.startswith("W"))
    for i in range(1, n + 1):
        h = mm(h, p[f"W{i}"])
        if i < n:
            h = torch.relu(h)
    return y1 + y2 + h.reshape(-1)


def flops(cfg: dict, batch: int, train: bool) -> float:
    """The products' multiply-adds counted twice and the second-order
    term's operations, a batch: the forward (3 F D + 3 D a row for the
    term), and with `train` the backward (weight gradients, input
    gradients but the dense features', 2 F D a row for the term)."""
    s = shapes(cfg)
    F, D = cfg["num_sparse"], cfg["embedding_dim"]
    fwd = sum(2.0 * batch * m * n for m, n in s.values()) \
        + batch * (3.0 * F * D + 3.0 * D)
    if not train:
        return fwd
    gemm = sum(2.0 * batch * m * n for m, n in s.values())
    dx = sum(2.0 * batch * m * n for k, (m, n) in s.items() if k != "FM_W")
    return fwd + gemm + dx + batch * 2.0 * F * D
