"""K1 `embedding_gather` and the embedding ops of the port against the JAX
package: the Pallas kernel (interpret mode, as tests/test_pallas_kernels.py
runs it), `jnp.take` and the engine's `mode="fill"` read. Gathers are
bit-exact: they copy rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herald_tpu.ops.embedding import dedup_ids as jax_dedup_ids
from herald_tpu.ops.pallas import embedding_gather as pallas_gather
from herald_tpu_torch.ops import dedup_ids, embedding_lookup
from herald_tpu_torch.ops.kernels import embedding_gather, embedding_gather_ref

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tables(R, D, name, seed):
    """The same table in JAX and torch (bf16: the same bit patterns)."""
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(seed)
    jt = jnp.asarray(rng.standard_normal((R, D)).astype(np.float32), jdt)
    host = np.asarray(jt)
    if name == "bf16":
        tt = torch.from_numpy(host.view(np.int16).copy()).view(torch.bfloat16)
    else:
        tt = torch.from_numpy(host.copy())
    return jt, tt


def _bits(x):
    """Bit patterns of a JAX or torch array, for exact comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.int32)
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_plain_gather_bit_exact_vs_pallas_and_take(name, id_dtype):
    # the shapes of tests/test_pallas_kernels.py:12-18
    jt, tt = _tables(512, 128, name, seed=0)
    ids = np.random.default_rng(1).integers(0, 512, 60).astype(np.int32)
    got = embedding_gather(tt, torch.from_numpy(ids).to(id_dtype))
    assert got.dtype == tt.dtype and got.shape == (60, 128)
    pal = pallas_gather(jt, jnp.asarray(ids), interpret=True)
    np.testing.assert_array_equal(_bits(got), _bits(pal))
    np.testing.assert_array_equal(_bits(got), _bits(jnp.take(jt, ids, 0)))


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_out_of_range_ids_give_zero_rows_like_fill_read(name):
    # R not a multiple of 8, D with a ragged width; positive out-of-range
    # ids, as the JAX engine's sentinel (table.shape[0] + 1) is
    R, D = 1001, 13
    jt, tt = _tables(R, D, name, seed=2)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, R, 300).astype(np.int32)
    ids[::7] = R + rng.integers(0, 1000, len(ids[::7]))
    ids[5] = R
    got = embedding_gather(tt, torch.from_numpy(ids))
    want = jt.at[jnp.asarray(ids)].get(mode="fill", fill_value=0)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not got[torch.from_numpy(ids >= R)].any()


def test_negative_ids_give_zero_rows():
    # the JAX fill read wraps negative ids; no JAX caller passes them, and
    # the port zero-fills every id outside [0, R)
    _, tt = _tables(64, 8, "f32", seed=4)
    ids = torch.tensor([-1, 3, -64, 63, -1000, 64], dtype=torch.int64)
    got = embedding_gather(tt, ids)
    assert torch.equal(got[[1, 3]], tt[[3, 63]])
    assert not got[[0, 2, 4, 5]].any()
    assert embedding_gather(tt, ids[:0]).shape == (0, 8)


def test_cpu_call_does_not_count_a_launch():
    _, tt = _tables(64, 8, "bf16", seed=5)
    before = embedding_gather.launches
    embedding_gather(tt, torch.arange(10))
    embedding_lookup(tt, torch.arange(12).reshape(3, 4))
    assert embedding_gather.launches == before


def test_embedding_lookup_shape_and_values():
    jt, tt = _tables(200, 16, "f32", seed=6)
    ids = np.random.default_rng(7).integers(0, 200, (5, 26))
    got = embedding_lookup(tt, torch.from_numpy(ids))
    assert got.shape == (5, 26, 16)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.take(jt, ids, 0)))


@pytest.mark.parametrize("n_ids,size", [(64, 64), (64, 100), (416, 416)])
def test_dedup_ids_matches_jax(n_ids, size):
    ids = np.random.default_rng(n_ids + size).integers(
        0, 300, (n_ids // 16, 16)).astype(np.int32)
    ju, jinv, jnum = (np.asarray(x) for x in
                      jax_dedup_ids(jnp.asarray(ids), size=size))
    tu, tinv, tnum = dedup_ids(torch.from_numpy(ids), size)
    real = len(np.unique(ids))
    assert int(tnum) == real and tu.shape == (size,)
    # the real slots and the inverse equal JAX's; the port's padding
    # repeats the largest id, as the JAX docstring states
    np.testing.assert_array_equal(tu[:real].numpy(), ju[:real])
    np.testing.assert_array_equal(tinv.numpy(), jinv)
    assert (tu[real:] == int(ids.max())).all()
    np.testing.assert_array_equal(tu[tinv].numpy(), ids.reshape(-1))
    if real == size:
        assert int(jnum) == real
    with pytest.raises(ValueError, match="exceed"):
        dedup_ids(torch.from_numpy(ids), real - 1)


def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode "
                    "(chip_smoke.py runs the full comparison on the card)")
    rng = np.random.default_rng(8)
    for dt in (torch.float32, torch.bfloat16):
        for R, D, N in ((512, 128, 60), (1001, 13, 300), (4096, 128, 6656)):
            table = torch.randn(R, D, device="cuda").to(dt)
            ids = torch.from_numpy(rng.integers(-R // 10, R + R // 10, N)
                                   ).cuda()
            before = embedding_gather.launches
            got = embedding_gather(table, ids)
            torch.cuda.synchronize()
            assert embedding_gather.launches == before + 1
            assert torch.equal(got, embedding_gather_ref(table, ids))
