"""The port's `DevicePrefetcher` (`herald_tpu_torch/data/prefetch.py`)
against herald_tpu's, on the CPU: the two tests of tests/test_prefetch.py
(the same chunks, in order, the tail wrapped from the head), a rank's
block of every global batch over S = 2, the short last chunk of
`drop_last=True`, `close()` in mid-stream, and a staging error raised in
the consumer."""

import threading

import numpy as np
import pytest
import torch

from herald_tpu.data.prefetch import DevicePrefetcher as JaxPrefetcher
from herald_tpu_torch.data import DevicePrefetcher
from herald_tpu_torch.train.graphs import PackedSteps


def _arrays(chunk):
    assert isinstance(chunk, PackedSteps) and chunk.packed.device.type \
        == "cpu"
    return [t.numpy() for t in chunk.tensors().values()]


def _jax_chunks(arrays, dtypes, epochs=1, **kw):
    pf = JaxPrefetcher(arrays, dtypes=dtypes, **kw)
    return [[np.asarray(a) for a in c] for c in pf(epochs=epochs)], pf


def test_prefetcher_covers_dataset_in_order():
    n, K, gb = 64, 4, 4
    x = np.arange(n, dtype=np.int32)
    pf = DevicePrefetcher([x], steps_per_chunk=K, global_batch=gb,
                          dtypes=[np.int32], device="cpu")
    chunks = [_arrays(c) for c in pf(epochs=1)]
    want, _ = _jax_chunks([x], [np.int32], steps_per_chunk=K,
                          global_batch=gb)
    assert len(chunks) == len(want) == n // (K * gb) == pf.num_chunks
    for a, b in zip(chunks, want):
        assert a[0].dtype == b[0].dtype and a[0].shape == b[0].shape
        np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(
        np.concatenate([c[0].reshape(-1) for c in chunks]), x)


def test_prefetcher_epochs_and_wrap():
    n, K, gb = 20, 2, 4     # 20 samples, chunk = 8 -> 2 chunks + drop
    rng = np.random.default_rng(0)
    arrays = [np.arange(n, dtype=np.float32),
              rng.integers(0, 99, (n, 3)).astype(np.int64),
              rng.random(n)]
    dtypes = [np.float32, np.int32, np.float32]
    pf = DevicePrefetcher(arrays, steps_per_chunk=K, global_batch=gb,
                          dtypes=dtypes, device="cpu", drop_last=False)
    chunks = [_arrays(c) for c in pf(epochs=2)]
    want, jpf = _jax_chunks(arrays, dtypes, epochs=2, steps_per_chunk=K,
                            global_batch=gb, drop_last=False)
    assert len(chunks) == len(want) == 2 * pf.num_chunks == 2 * jpf.num_chunks
    for a, b in zip(chunks, want):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    # the wrapped tail chunk pads from the head
    np.testing.assert_array_equal(chunks[pf.num_chunks - 1][0].reshape(-1)[
        -4:], [0, 1, 2, 3])


@pytest.mark.parametrize("rank", [0, 1])
def test_a_rank_stages_its_block_of_each_global_batch(rank):
    """Over S = 2 ranks a chunk holds rows [r*b, (r+1)*b) of each global
    batch of JAX's chunk: half of its bytes."""
    n, K, gb = 96, 3, 8
    rng = np.random.default_rng(1)
    arrays = [rng.random((n, 5)), rng.integers(0, 50, (n, 4)),
              rng.integers(0, 2, n)]
    dtypes = [np.float32, np.int32, np.float32]
    pf = DevicePrefetcher(arrays, steps_per_chunk=K, global_batch=gb,
                          dtypes=dtypes, device="cpu", rank=rank, ranks=2)
    want, _ = _jax_chunks(arrays, dtypes, steps_per_chunk=K,
                          global_batch=gb)
    got = list(pf(epochs=1))
    assert len(got) == len(want) == 4
    for chunk, jx in zip(got, want):
        assert chunk.steps == K
        for x, y in zip(_arrays(chunk), jx):
            np.testing.assert_array_equal(x, y[:, rank * 4:(rank + 1) * 4])
        whole = sum(y.nbytes for y in jx)
        assert sum(f.nbytes for f in chunk.layout.fields) * K == whole // 2


def test_drop_last_trains_every_full_batch():
    """The launcher's chunks: an epoch's last chunk holds the remaining
    full batches (what JAX's prefetcher drops,
    test_torch_feed.py::test_jax_prefetcher_drops_the_epochs_tail)."""
    n, K, gb = 100, 4, 7            # 14 full batches: chunks 4, 4, 4, 2
    x = np.arange(n, dtype=np.int32)
    pf = DevicePrefetcher([x], steps_per_chunk=K, global_batch=gb,
                          dtypes=[np.int32], device="cpu")
    assert pf.steps_per_epoch == 14 and pf.num_chunks == 4
    chunks = [_arrays(c)[0] for c in pf(epochs=2)]
    assert [c.shape[0] for c in chunks] == [4, 4, 4, 2] * 2
    for ep in range(2):
        np.testing.assert_array_equal(
            np.concatenate([c.reshape(-1) for c in chunks[4 * ep:
                                                          4 * ep + 4]]),
            x[:14 * gb])


def test_close_mid_stream_stops_the_worker():
    n, K, gb = 4096, 2, 4
    x = np.arange(n, dtype=np.int32)
    pf = DevicePrefetcher([x], steps_per_chunk=K, global_batch=gb,
                          dtypes=[np.int32], device="cpu", depth=2)
    it = pf(epochs=3)
    first = [_arrays(next(it))[0] for _ in range(3)]
    np.testing.assert_array_equal(np.concatenate(
        [c.reshape(-1) for c in first]), x[:3 * K * gb])
    pf.close()
    assert not pf._thread.is_alive() and pf._q.empty()
    assert threading.active_count() < 50


def test_staging_error_is_raised_in_the_consumer():
    x = np.array(["1", "2", "x", "4"] * 8, dtype=object)
    pf = DevicePrefetcher([x], steps_per_chunk=2, global_batch=4,
                          dtypes=[np.float32], device="cpu")
    got = []
    with pytest.raises(ValueError, match="could not convert"):
        for c in pf(epochs=1):
            got.append(c)
    assert not got
    assert not pf._thread.is_alive()


def test_no_card_raises_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePrefetcher([np.zeros(8)], 1, 4, [np.float32])
