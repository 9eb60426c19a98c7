"""The seeded inputs: the same seed gives the same stream and weights,
and the reference makes the table's rows again by itself."""

import numpy as np
import torch

from portbench import gen


def stream(seed, n=4096):
    return gen.ctr_stream(n, 50_000, 26, 13, 1.2, 2.0, 0, seed, "cpu")


def test_same_seed_same_stream():
    a, b = stream(2**31 + 5), stream(2**31 + 5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = stream(2**31 + 6)
    assert not torch.equal(a[1], c[1])


def test_stream_shapes_and_ranges():
    dense, ids, labels = stream(3)
    assert dense.shape == (4096, 13) and dense.dtype == torch.float32
    assert ids.shape == (4096, 26) and ids.dtype == torch.int32
    assert labels.shape == (4096, 1)
    offsets, sizes = gen.field_slices(50_000, 26, 2.0, 0)
    for f in range(26):
        col = ids[:, f].long().numpy()
        assert col.min() >= offsets[f] and col.max() < offsets[f] + sizes[f]
    assert 0.4 < float(labels.mean()) < 0.6


def test_zeta_head():
    """P(1) of zeta(1.2) is 1 / zeta(1.2) = 0.1792."""
    x = gen.zeta(torch.Generator().manual_seed(0), 1.2, (200_000,), "cpu")
    assert abs(float((x == 1).double().mean()) - 0.1792) < 0.005
    assert float(x.min()) >= 1


def test_table_rows_redrawn_exactly():
    rows, W = 9000, 8
    old = gen.TABLE_CHUNK_ROWS
    gen.TABLE_CHUNK_ROWS = 4096
    try:
        table = torch.empty((rows + 3, W), dtype=torch.bfloat16)
        gen.fill_table(table, rows, 17)
        ids = torch.as_tensor(np.array([0, 5, 4095, 4096, 8999]))
        again = gen.table_rows(ids, rows, W, torch.bfloat16, 17)
    finally:
        gen.TABLE_CHUNK_ROWS = old
    assert torch.equal(again, table[ids])
    assert torch.equal(table[rows:], torch.zeros((3, W), dtype=torch.bfloat16))


def test_large_and_negative_seeds():
    for s in (2**31 + 1, 2**40, -3):
        assert 0 <= gen.sub_seed(s, gen.STREAM) < 2**63
