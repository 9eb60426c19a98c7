"""K4 `hot_onehot_gather` and its add form `hot_onehot_gather_add_` of the
port against the JAX package: the Pallas kernel in interpret mode (as
tests/test_pallas_kernels.py:49-59 runs it) and the XLA fill read the JAX
cached engine uses for the pinned tier
(`hot_table.at[where(pinned, uniq, P + 1)].get(mode="fill")`,
`herald_tpu/train/cached.py:461-467`), for the add form with the add that
follows it.

Tolerances: the port is exactly `hot_table[ids]` with zero rows outside
[0, H), so it is bit-exact against the XLA fill read for every dtype.
The Pallas kernel multiplies a bf16 one-hot by the table on the MXU, so it
is exact for a bf16 table; for an f32 table it agrees within the
1e-6 that tests/test_pallas_kernels.py holds it to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herald_tpu.ops.pallas import hot_onehot_gather as pallas_hot_gather
from herald_tpu_torch.ops.kernels import (KERNELS, hot_onehot_gather,
                                          hot_onehot_gather_add_,
                                          hot_onehot_gather_add_ref,
                                          hot_onehot_gather_ref)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(name, H=256, D=128, N=96, seed=3):
    # the shape of tests/test_pallas_kernels.py:49-59: 30% cold ids
    jdt, _ = DTYPES[name]
    rng = np.random.default_rng(seed)
    table = jnp.asarray(rng.standard_normal((H, D)), jdt)
    ids = np.where(rng.random(N) < 0.7, rng.integers(0, H, N),
                   1_000_000).astype(np.int32)
    return table, ids


def _xla_fill_read(table, ids):
    """The JAX engine's pinned read: mask, positive sentinel, fill read."""
    H = table.shape[0]
    safe = np.where((ids >= 0) & (ids < H), ids, H + 1)
    return table.at[jnp.asarray(safe)].get(mode="fill", fill_value=0)


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_hot_gather_matches_pallas_and_fill_read(name, id_dtype):
    table, ids = _inputs(name)
    out = hot_onehot_gather(_to_torch(table),
                            torch.from_numpy(ids).to(id_dtype))
    assert out.dtype == DTYPES[name][1] and out.shape == (96, 128)
    np.testing.assert_array_equal(_f32(out), _f32(_xla_fill_read(table,
                                                                 ids)))
    pal = pallas_hot_gather(table, jnp.asarray(ids), block_ids=32,
                            interpret=True)
    if name == "bf16":
        np.testing.assert_array_equal(_f32(out), _f32(pal))
    else:
        np.testing.assert_allclose(_f32(out), _f32(pal), rtol=1e-6,
                                   atol=1e-6)
    assert not _f32(out)[ids >= 256].any()


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_hot_gather_negative_ids_and_raw_uniq(name):
    """Negative ids give zero rows, so the raw step `uniq` (-1 padding,
    ids >= P) needs no mask: the kernel's bounds check is the pinned
    mask of the JAX engine."""
    table, _ = _inputs(name, H=64, D=8)
    uniq = np.concatenate([np.array([0, 5, 63, 64, 200, 1_000_000]),
                           np.full(10, -1)]).astype(np.int32)
    out = hot_onehot_gather(_to_torch(table), torch.from_numpy(uniq))
    np.testing.assert_array_equal(_f32(out), _f32(_xla_fill_read(table,
                                                                 uniq)))
    assert not _f32(out)[3:].any()
    neg = hot_onehot_gather(_to_torch(table),
                            torch.tensor([-1, -64, -1000]))
    assert not neg.float().any()


def test_hot_gather_empty_and_narrow_rows():
    table, _ = _inputs("f32", H=100, D=13)
    t = _to_torch(table)
    empty = hot_onehot_gather(t, torch.zeros(0, dtype=torch.int32))
    assert empty.shape == (0, 13)
    ids = torch.tensor([99, 0, 100, -2, 42])
    out = hot_onehot_gather(t, ids)
    assert torch.equal(out, hot_onehot_gather_ref(t, ids))
    np.testing.assert_array_equal(out.numpy()[[0, 1, 4]],
                                  np.asarray(table)[[99, 0, 42]])


def test_hot_gather_launch_counter_stays_put_on_the_cpu():
    before = {k: f.launches for k, f in KERNELS.items()}
    table, ids = _inputs("f32")
    hot_onehot_gather(_to_torch(table), torch.from_numpy(ids))
    assert "hot_onehot_gather" in KERNELS
    assert {k: f.launches for k, f in KERNELS.items()} == before


def test_hot_gather_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(chip_smoke.py runs this check on the card)")
    for name in ("f32", "bf16"):
        table, ids = _inputs(name)
        t = _to_torch(table).cuda()
        i = torch.from_numpy(ids).cuda()
        n0 = hot_onehot_gather.launches
        out = hot_onehot_gather(t, i)
        assert hot_onehot_gather.launches == n0 + 1
        assert torch.equal(out, hot_onehot_gather_ref(t, i))
    with pytest.raises(ValueError, match="one card"):
        hot_onehot_gather(t, torch.from_numpy(ids))
    torch.cuda.synchronize()


# ----------------------------------------------------------------------
# the add form, hot_onehot_gather_add_: the pinned tier's read, widening
# and add in one in-place launch. Its plain version is bit-exact against
# the JAX engine's expression on every row that expression writes a
# value into, and keeps a cold row's bits (-0.0 included) where JAX's
# `x + 0.0` turns -0.0 into +0.0; assert_array_equal counts the two
# zeros equal, the bit checks below read the words.

def _raw_uniq(rng, P, N):
    """A step's raw uniq: hot ids in [0, P), cold ids >= P and -1 padding
    at the end, as the planner pops them."""
    n_pad = N // 5
    live = np.where(rng.random(N - n_pad) < 0.4,
                    rng.integers(0, P, N - n_pad),
                    rng.integers(P, 50 * P, N - n_pad))
    return np.concatenate([live, np.full(n_pad, -1)]).astype(np.int32)


def _add_inputs(name, D, N=80, P=48, seed=11):
    jdt, _ = DTYPES[name]
    rng = np.random.default_rng(seed)
    table = jnp.asarray(rng.standard_normal((P, D)), jdt)
    uniq = _raw_uniq(rng, P, N)
    emb = rng.standard_normal((N, D)).astype(np.float32)
    emb[uniq < 0] = 0.0            # padding rows read the fill value
    emb[1::4] = -0.0               # cold and hot rows holding -0.0
    return table, uniq, emb


def _jax_pinned_read(emb, table, uniq):
    """herald_tpu/train/cached.py:461-467 on the raw uniq."""
    P = table.shape[0]
    u = jnp.asarray(uniq)
    hot_ids = jnp.where((u >= 0) & (u < P), u, P + 1)
    rows = table.at[hot_ids].get(mode="fill", fill_value=0)
    return jnp.asarray(emb) + rows.astype(jnp.float32)


def _bits(x):
    return np.ascontiguousarray(x).view(np.int32)


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("D", [8, 13, 128, 513])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_hot_gather_add_matches_jax_pinned_read_and_pallas(name, id_dtype, D,
                                                           strided):
    table, uniq, emb = _add_inputs(name, D)
    N = len(uniq)
    # strided: the value half of a fused [N, 2D] read, as the cached step
    # hands it over; the delta half must come through untouched
    base = np.random.default_rng(5).standard_normal(
        (N, 2 * D if strided else D)).astype(np.float32)
    base[:, :D] = emb
    buf = torch.from_numpy(base.copy())
    acc = buf[:, :D]
    assert acc.is_contiguous() != strided
    ids = torch.from_numpy(uniq).to(id_dtype)
    out = hot_onehot_gather_add_(acc, _to_torch(table), ids)
    assert out is acc and out.dtype == torch.float32
    got = acc.numpy()
    np.testing.assert_array_equal(got, np.asarray(_jax_pinned_read(
        emb, table, uniq)))
    pal = pallas_hot_gather(table, jnp.asarray(uniq), block_ids=32,
                            interpret=True)
    want = np.asarray(jnp.asarray(emb) + pal.astype(jnp.float32))
    if name == "bf16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # cold rows (-1 padding and ids >= P) keep their exact bits, -0.0
    # included; hot rows are emb + the widened row, bit for bit
    cold = (uniq < 0) | (uniq >= table.shape[0])
    assert (_bits(emb[cold]) == _bits(got[cold])).all()
    assert (np.signbit(got[cold]) == np.signbit(emb[cold])).all()
    assert np.signbit(emb[cold]).any()
    hot_rows = np.asarray(jnp.asarray(table, jnp.float32))[uniq[~cold]]
    assert (_bits(got[~cold]) == _bits(emb[~cold] + hot_rows)).all()
    if strided:
        assert (_bits(buf.numpy()[:, D:]) == _bits(base[:, D:])).all()


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_hot_gather_add_empty_and_all_cold(name):
    table, _, _ = _add_inputs(name, 13)
    t = _to_torch(table)
    empty = torch.zeros((0, 13))
    assert hot_onehot_gather_add_(empty, t, torch.zeros(0, dtype=torch.int32)
                                  ) is empty
    acc = torch.full((4, 13), -0.0)
    hot_onehot_gather_add_(acc, t, torch.tensor([-1, 48, 10 ** 6, -7]))
    assert torch.equal(acc.view(torch.int32),
                       torch.full((4, 13), -0.0).view(torch.int32))


def test_hot_gather_add_ref_is_the_gather_then_add():
    """The add form is K4's gather widened and added on the in-range rows:
    from a zero acc it gives the gather itself, widened."""
    table, uniq, _ = _add_inputs("bf16", 128)
    t, ids = _to_torch(table), torch.from_numpy(uniq)
    acc = hot_onehot_gather_add_ref(torch.zeros(len(uniq), 128), t, ids)
    assert torch.equal(acc, hot_onehot_gather_ref(t, ids).float())


def test_hot_gather_add_launch_counter_stays_put_on_the_cpu():
    before = {k: f.launches for k, f in KERNELS.items()}
    table, uniq, emb = _add_inputs("bf16", 128)
    hot_onehot_gather_add_(torch.from_numpy(emb), _to_torch(table),
                           torch.from_numpy(uniq))
    assert "hot_onehot_gather_add_" in KERNELS
    assert {k: f.launches for k, f in KERNELS.items()} == before


def test_hot_gather_add_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(chip_smoke.py runs this check on the card)")
    for name in ("f32", "bf16"):
        for D, strided in ((128, False), (128, True), (513, True)):
            table, uniq, emb = _add_inputs(name, D)
            t = _to_torch(table).cuda()
            i = torch.from_numpy(uniq).cuda()
            buf = torch.randn(len(uniq), 2 * D if strided else D,
                              device="cuda")
            buf[:, :D] = torch.from_numpy(emb).cuda()
            want = buf.clone()
            hot_onehot_gather_add_ref(want[:, :D], t, i)
            n0 = hot_onehot_gather_add_.launches
            hot_onehot_gather_add_(buf[:, :D], t, i)
            assert hot_onehot_gather_add_.launches == n0 + 1
            assert torch.equal(buf.view(torch.int32),
                               want.view(torch.int32))
    with pytest.raises(ValueError, match="one card"):
        hot_onehot_gather_add_(buf[:, :D], t, torch.from_numpy(uniq))
    with pytest.raises(ValueError, match="float32"):
        hot_onehot_gather_add_(buf[:, :D].double(), t, i)
    torch.cuda.synchronize()
