"""The dedup's `unique_fill` kernel (`ops/kernels/unique.py`) and the rule
that chooses it (`ops/embedding.py` `unique_fill`).

On the CPU: the rule takes the library chain, whose outputs are JAX's
`jnp.unique(size=..., fill_value=..., return_inverse=True)` as numpy
states it, and launches nothing; the rule reads only the ids' device,
dtype and count. On a card (skipped without one): the kernel's `uniq` and
`inv` equal the chain's on the same card bit for bit, at every size, cut
and fill, alone and captured in a CUDA graph; past its capacity or for
int64 ids the chain runs; the plain engine launches it once a step and the
cached engine never. This file imports no JAX, so it runs on the card with
`python -m pytest --noconftest tests/test_torch_unique.py`.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from herald_tpu_torch.ops import embedding
from herald_tpu_torch.ops.kernels import KERNELS, unique
from herald_tpu_torch.ops.kernels.unique import (CAPACITY, unique_fill,
                                                 unique_fill_ref)

ROWS = 27_000_000
I32 = np.iinfo(np.int32)
SIZES_N = (1, 63, 64, 6656, CAPACITY)
KINDS = ("equal", "distinct", "zipf", "negative", "extremes", "one_part")


def _ids(kind: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "equal":
        return np.full(n, 1234567, np.int32)
    if kind == "distinct":
        return rng.permutation(ROWS)[:n].astype(np.int32)
    if kind == "zipf":
        return ((rng.zipf(1.2, n) - 1) % ROWS).astype(np.int32)
    if kind == "negative":
        return rng.integers(-5000, 5000, n).astype(np.int32)
    if kind == "one_part":
        # distinct ids, one of them far above the rest: on the card the
        # rest share one block of the kernel's cluster, up to 8,191 of them
        a = rng.permutation(n).astype(np.int32)
        a[a == n - 1] = 1 << 30
        return a
    a = rng.integers(I32.min, I32.max, n, endpoint=True).astype(np.int32)
    a[::3] = I32.max
    a[1::5] = -I32.max
    a[2::7] = I32.min
    return a


def _numpy_unique(ids: np.ndarray, size: int, fill: int):
    """jnp.unique(ids, size=size, fill_value=fill, return_inverse=True)."""
    u = np.unique(ids)
    uniq = np.full(size, fill, ids.dtype)
    uniq[:min(size, u.size)] = u[:size]
    return uniq, np.searchsorted(u, ids).astype(np.int64)


def _cases():
    for n in SIZES_N:
        for size in (max(n // 3, 1), n, n + 37):
            for fill in (-1, ROWS):
                yield n, size, fill


# ----------------------------------------------------------------------
# the CPU: the chain, and the rule
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_cpu_dedup_is_the_chain_and_jnp_unique(kind, dtype):
    before = unique_fill.launches
    for n, size, fill in _cases():
        ids = _ids(kind, n, seed=n + size)
        want_u, want_inv = _numpy_unique(ids, size, fill)
        got_u, got_inv = embedding.unique_fill(
            torch.from_numpy(ids).to(dtype), size, fill)
        assert got_u.dtype == dtype and got_inv.dtype == torch.int64
        np.testing.assert_array_equal(got_u.numpy(), want_u)
        np.testing.assert_array_equal(got_inv.numpy(), want_inv)
        ref_u, ref_inv = unique_fill_ref(torch.from_numpy(ids).to(dtype),
                                         size, fill)
        assert torch.equal(got_u, ref_u) and torch.equal(got_inv, ref_inv)
    assert unique_fill.launches == before


def test_cpu_unique_static_is_unchanged():
    ids = _ids("zipf", 6656, seed=3).reshape(256, 26)
    t = torch.from_numpy(ids)
    u, inv = embedding.unique_static(t, t.numel())
    want_u, want_inv = _numpy_unique(ids.reshape(-1), t.numel(), -1)
    np.testing.assert_array_equal(u.numpy(), want_u)
    np.testing.assert_array_equal(inv.numpy(), want_inv)
    assert "unique_fill" in KERNELS and KERNELS["unique_fill"] is unique_fill


def test_rule_reads_only_device_dtype_and_count():
    def ids(cuda, dtype, n):
        return SimpleNamespace(is_cuda=cuda, dtype=dtype, numel=lambda: n)

    assert unique.fits(ids(True, torch.int32, CAPACITY))
    assert unique.fits(ids(True, torch.int32, 1))
    assert not unique.fits(ids(True, torch.int32, CAPACITY + 1))
    assert not unique.fits(ids(True, torch.int64, 64))
    assert not unique.fits(ids(False, torch.int32, 64))
    assert not unique.fits(torch.zeros(64, dtype=torch.int32))
    assert CAPACITY >= 256 * 26      # a wdl step's ids at batch 256


# ----------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    assert a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_is_the_chain_bit_for_bit(card, kind):
    for n, size, fill in _cases():
        ids = torch.from_numpy(_ids(kind, n, seed=n + size)).to(card)
        before = unique_fill.launches
        got = embedding.unique_fill(ids, size, fill)
        assert unique_fill.launches == before + 1
        _same(got, unique_fill_ref(ids, size, fill))
        want = _numpy_unique(ids.cpu().numpy(), size, fill)
        np.testing.assert_array_equal(got[0].cpu().numpy(), want[0])
        np.testing.assert_array_equal(got[1].cpu().numpy(), want[1])
    torch.cuda.synchronize()


def test_kernel_edges(card):
    empty = torch.zeros(0, dtype=torch.int32, device=card)
    _same(unique_fill(empty, 5, 7), unique_fill_ref(empty, 5, 7))
    ids = torch.tensor([9, -3, 9], dtype=torch.int32, device=card)
    _same(unique_fill(ids, 0, -1), unique_fill_ref(ids, 0, -1))
    _same(unique_fill(ids.view(3, 1), 4, -1), unique_fill_ref(ids, 4, -1))
    with pytest.raises(ValueError, match="int32"):
        unique_fill(ids, 4, 2**31)
    torch.cuda.synchronize()


def test_past_capacity_and_int64_take_the_chain(card):
    big = torch.from_numpy(_ids("zipf", CAPACITY + 1, seed=5)).to(card)
    wide = torch.from_numpy(_ids("zipf", 6656, seed=6)).to(card).long()
    before = unique_fill.launches
    for ids in (big, wide):
        _same(embedding.unique_fill(ids, ids.numel(), -1),
              unique_fill_ref(ids, ids.numel(), -1))
    assert unique_fill.launches == before
    with pytest.raises(ValueError, match="at most"):
        unique_fill(big, big.numel(), -1)
    with pytest.raises(ValueError, match="at most"):
        unique_fill(wide, wide.numel(), -1)
    torch.cuda.synchronize()


def test_kernel_in_a_captured_graph(card):
    n = 6656
    static = torch.from_numpy(_ids("zipf", n, seed=7)).to(card)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        embedding.unique_fill(static, n, -1)        # loads the library
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = unique_fill.launches
    with torch.cuda.graph(graph):
        out = embedding.unique_fill(static, n, -1)
    assert unique_fill.launches == before + 1
    for seed in (8, 9, 10):
        fresh = torch.from_numpy(_ids("zipf", n, seed=seed)).to(card)
        static.copy_(fresh)
        graph.replay()
        torch.cuda.synchronize()
        _same(out, unique_fill_ref(fresh, n, -1))


def test_plain_steps_launch_it_once_each_and_cached_steps_never(card):
    from herald_tpu_torch import HeraldConfig
    from herald_tpu_torch.data import synthetic_ctr_data
    from herald_tpu_torch.models import get_model
    from herald_tpu_torch.train.cached import CachedEngine
    from herald_tpu_torch.train.engine import Engine

    B, rows, steps = 256, 100_000, 20
    cfg = HeraldConfig(model="wdl_criteo", batch_size=B, embedding_dim=16,
                       cache_limit=20_000)
    d, s, y = synthetic_ctr_data(get_model("wdl_criteo").spec, B * steps,
                                 seed=11, num_rows=rows)
    eng = Engine(cfg, table_rows=rows, device=card)
    st = eng.init_state(0)
    st, _ = eng.train_epoch(st, d, s, y, steps=steps)   # warm-up, capture
    before = unique_fill.launches
    st, stats = eng.train_epoch(st, d, s, y, steps=steps)
    torch.cuda.synchronize()
    assert unique_fill.launches == before + steps
    assert torch.isfinite(stats["loss"]).all()

    ceng = CachedEngine(cfg, table_rows=rows, device=card)
    cst = ceng.init_cached_state(0)
    planner = ceng.make_planner(s, epochs=2, n_threads=1)
    cst, _ = ceng.train_epoch_cached(cst, planner, d, s, y, steps=steps)
    before = unique_fill.launches
    cst, _ = ceng.train_epoch_cached(cst, planner, d, s, y, steps=steps)
    torch.cuda.synchronize()
    assert unique_fill.launches == before
