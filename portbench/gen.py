"""The benchmark's seeded inputs, made on the device: the CTR stream and
the weights.

The stream rewrites the synthetic Criteo-shaped generator of the program
(`herald_tpu_torch/data/datasets.py`, `synthetic_ctr_data`) for the card:
each sparse field owns a slice of one global id space, the slices split
the table's rows by a Dirichlet draw, a field's ids follow a Zipf law
over its slice (the zeta distribution, folded into the slice), dense
features are standard normals and labels come from a hidden linear model
over the dense features and hashed id signs. The program gets only the
arrays. The same seed gives the same stream on one kind of device (the
card's generator and the CPU's differ).

Every purpose draws from a generator of its own (`generator(seed,
purpose)`), so the stream does not depend on the weights and the
reference can make either again by itself.
"""

from __future__ import annotations

import numpy as np
import torch

# purposes of the generators drawn from one seed
STREAM, TABLE, TOWER, SAMPLE = 1, 2, 3, 4
# rows of the table drawn a call
TABLE_CHUNK_ROWS = 1 << 22


def sub_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed of its own for each purpose of one run seed (any
    whole number)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + purpose * 0xBF58476D1CE4E5B9) \
        % (1 << 63)


def generator(seed: int, purpose: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        sub_seed(seed, purpose))


def field_slices(num_rows: int, fields: int, alpha: float, split_seed: int):
    """(offsets, sizes) of each field's slice of [0, num_rows): a
    Dirichlet(alpha) split drawn from the mix's own `split_seed`, not the
    run's, so that every run seed gets the same slices and so the same
    work; each slice at least 2 rows, the excess of that floor shaved off
    the largest slices."""
    rng = np.random.default_rng(split_seed)
    props = rng.dirichlet(np.full(fields, alpha))
    sizes = np.maximum((props * num_rows).astype(np.int64), 2)
    excess = int(sizes.sum()) - num_rows
    while excess > 0:
        i = int(np.argmax(sizes))
        take = min(excess, int(sizes[i]) - 2)
        sizes[i] -= take
        excess -= take
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return offsets, sizes


def zeta(gen: torch.Generator, a: float, shape, device) -> torch.Tensor:
    """Draws of the zeta distribution, P(k) = k^-a / zeta(a), k >= 1, as
    float64 (Devroye's rejection method; rejected draws are drawn again
    until none is left)."""
    am1 = a - 1.0
    b = 2.0 ** am1
    n = int(np.prod(shape))
    out = torch.empty(n, dtype=torch.float64, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        m = todo.numel()
        u = 1.0 - torch.rand(m, generator=gen, dtype=torch.float64,
                             device=device)          # (0, 1]
        v = torch.rand(m, generator=gen, dtype=torch.float64, device=device)
        x = torch.floor(u.pow(-1.0 / am1))
        t = (1.0 + 1.0 / x).pow(am1)
        ok = v * x * (t - 1.0) / (b - 1.0) <= t / b
        out[todo[ok]] = x[ok]
        todo = todo[~ok]
    return out.view(shape)


def ctr_stream(n: int, num_rows: int, fields: int, num_dense: int,
               zipf_a: float, alpha: float, split_seed: int, seed: int,
               device):
    """(dense f32 [n, num_dense], ids int32 [n, fields], labels f32 [n,
    1]) on `device`: the fields' slices from `split_seed`, every draw in
    them from `seed`."""
    gen = generator(seed, STREAM, device)
    offsets, sizes = field_slices(num_rows, fields, alpha, split_seed)
    raw = zeta(gen, zipf_a, (n, fields), device)
    size_t = torch.as_tensor(sizes, dtype=torch.float64, device=device)
    local = torch.fmod(raw - 1.0, size_t).long()
    ids = local + torch.as_tensor(offsets, device=device)
    del raw, local
    dense = torch.randn((n, num_dense), generator=gen, device=device)
    w = torch.randn(max(num_dense, 1), generator=gen, device=device)
    id_sign = ((ids * 2654435761) % 97 / 48.0 - 1.0).mean(dim=1)
    # elementwise, so the labels do not depend on the matmul precision
    logits = (dense * w[:num_dense]).sum(dim=1) + 2.0 * id_sign \
        + 0.1 * torch.randn(n, generator=gen, device=device)
    labels = (logits > logits.median()).to(torch.float32).view(n, 1)
    return dense, ids.to(torch.int32), labels


def fill_table(table: torch.Tensor, num_rows: int, seed: int) -> None:
    """Rows [0, num_rows) of `table` ~ 0.01 * N(0, 1) in its dtype, drawn
    TABLE_CHUNK_ROWS rows a call; the rest zero."""
    gen = generator(seed, TABLE, table.device)
    for c0 in range(0, num_rows, TABLE_CHUNK_ROWS):
        part = table[c0:min(c0 + TABLE_CHUNK_ROWS, num_rows)]
        part.normal_(generator=gen).mul_(0.01)
    table[num_rows:].zero_()


def table_rows(ids: torch.Tensor, num_rows: int, width: int, dtype,
               seed: int) -> torch.Tensor:
    """The rows `fill_table` draws for `ids` (int64, on the device that
    draws), made again chunk by chunk: [len(ids), width] in `dtype`."""
    device = ids.device
    gen = generator(seed, TABLE, device)
    out = torch.zeros((ids.numel(), width), dtype=dtype, device=device)
    buf = torch.empty((min(TABLE_CHUNK_ROWS, num_rows), width), dtype=dtype,
                      device=device)
    for c0 in range(0, num_rows, TABLE_CHUNK_ROWS):
        c1 = min(c0 + TABLE_CHUNK_ROWS, num_rows)
        part = buf[:c1 - c0]
        part.normal_(generator=gen).mul_(0.01)
        here = (ids >= c0) & (ids < c1)
        if bool(here.any()):
            pos = here.nonzero().view(-1)
            out[pos] = part[ids[pos] - c0]
    return out


def tower(shapes: dict, stddev: float, seed: int, device) -> dict:
    """{name: stddev * N(0, 1)} f32, in the order `shapes` gives."""
    gen = generator(seed, TOWER, device)
    return {k: stddev * torch.randn(tuple(s), generator=gen, device=device)
            for k, s in shapes.items()}
