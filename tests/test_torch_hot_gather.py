"""K4 `hot_onehot_gather` of the port against the JAX package: the Pallas
kernel in interpret mode (as tests/test_pallas_kernels.py:49-59 runs it)
and the XLA fill read the JAX cached engine uses for the pinned tier
(`hot_table.at[where(pinned, uniq, P + 1)].get(mode="fill")`,
`herald_tpu/train/cached.py:461-467`).

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
