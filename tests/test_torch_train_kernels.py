"""K2 `rows_scatter_add` and K3 `hot_onehot_push` of the port, and the
embedding ops built on them, against the JAX package: the Pallas kernels
in interpret mode (as tests/test_pallas_kernels.py runs them) and the XLA
ops the JAX engine uses in their place (`.at[].add`, `segment_sum`).

Tolerances:
- K2 is bit-exact: the grad is rounded to the table dtype and added once,
  as the Pallas kernel and `.at[].add` do for unique ids.
- K3 with integer-valued grads is bit-exact (every partial sum is exact).
  With random f32 grads the sums are taken in another order than the
  Pallas one-hot product and XLA's scatter, so they agree within
  1e-6 * sum|g| per element.
- `scatter_add_rows` rounds once per distinct row where JAX rounds per
  duplicate: f32 within 1e-6 * sum|v|; bf16 with dyadic values (exact
  sums) bit-exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from herald_tpu.ops.embedding import scatter_add_rows as jax_scatter_add_rows
from herald_tpu.ops.embedding import segment_sum_grads as jax_segment_sum
from herald_tpu.ops.pallas import hot_onehot_push as pallas_push
from herald_tpu.ops.pallas import rows_scatter_add as pallas_scatter
from herald_tpu_torch.ops import scatter_add_rows, segment_sum_grads
from herald_tpu_torch.ops.kernels import (KERNELS, gather_pool_rows,
                                          hot_onehot_push,
                                          hot_onehot_push_ref,
                                          rows_scatter_add,
                                          rows_scatter_add_ref)
from herald_tpu_torch.ops.kernels.segment import (PIECE, WARP_ROWS,
                                                  scratch_sizes)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _to_torch(a):
    """A JAX or numpy array as a torch tensor with the same bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x.view(torch.int32)).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


# ----------------------------------------------------------------------
# K2
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_rows_scatter_add_bit_exact_vs_pallas_and_at_add(name, id_dtype):
    # the shapes of tests/test_pallas_kernels.py:21-36
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(1)
    table = jnp.asarray(rng.standard_normal((104, 128)), jdt)
    ids = np.array([3, 7, 42, 99, 0, 55], np.int32)   # unique (contract)
    grads = rng.standard_normal((6, 128)).astype(np.float32)
    tt = _to_torch(table)
    before = tt.clone()
    out = rows_scatter_add(tt, torch.from_numpy(ids).to(id_dtype),
                           torch.from_numpy(grads))
    assert out is tt and out.dtype == tdt          # in place
    pal = pallas_scatter(jnp.array(table), jnp.asarray(ids),
                         jnp.asarray(grads), interpret=True)
    xla = table.at[ids].add(jnp.asarray(grads).astype(jdt))
    np.testing.assert_array_equal(_bits(tt), _bits(pal))
    np.testing.assert_array_equal(_bits(tt), _bits(xla))
    untouched = np.ones(104, bool)
    untouched[ids] = False
    assert torch.equal(tt[untouched], before[untouched])


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_rows_scatter_add_skips_out_of_range_like_drop_write(name):
    # D = 13 (no 4-wide vectors), R not a multiple of 8; ids outside [0, R)
    # are skipped like the JAX engine's mode="drop" write
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(2)
    R, D = 1001, 13
    table = jnp.asarray(rng.standard_normal((R, D)), jdt)
    ids = rng.permutation(R)[:300].astype(np.int64)
    ids[::7] = R + rng.integers(0, 50, len(ids[::7]))
    ids[3::11] = -1 - rng.integers(0, 50, len(ids[3::11]))
    grads = (rng.standard_normal((300, D)) * 0.1).astype(np.float32)
    tt = _to_torch(table)
    rows_scatter_add(tt, torch.from_numpy(ids), torch.from_numpy(grads))
    drop = np.where((ids >= 0) & (ids < R), ids, R + 1)
    xla = table.at[drop].add(jnp.asarray(grads).astype(jdt), mode="drop")
    np.testing.assert_array_equal(_bits(tt), _bits(xla))
    # N = 0 leaves the table as it was
    same = tt.clone()
    rows_scatter_add(tt, torch.zeros(0, dtype=torch.int64),
                     torch.zeros((0, D)))
    assert torch.equal(tt, same)


def test_rows_scatter_add_contract_is_unique_ids():
    """The rule the wrapper states and does not check on the card: ids
    must be unique. With a duplicate, one of its updates is lost (here
    the plain version keeps the last); `scatter_add_rows` is the entry
    that sums duplicates first."""
    ids = torch.tensor([2, 2])
    grads = torch.tensor([[1.0], [2.0]])
    once = rows_scatter_add(torch.zeros(4, 1), ids, grads)
    assert float(once[2]) in (1.0, 2.0)
    summed = scatter_add_rows(torch.zeros(4, 1), ids, grads)
    assert float(summed[2]) == 3.0


# ----------------------------------------------------------------------
# K3
# ----------------------------------------------------------------------

def _push_inputs(seed, H=256, D=128, N=200, ints=False, dtype=np.float32):
    # the shapes of tests/test_pallas_kernels.py:62-76: duplicates and
    # cold (out-of-range) ids
    rng = np.random.default_rng(seed)
    ids = np.where(rng.random(N) < 0.8, rng.integers(0, H, N),
                   1_000_000).astype(np.int32)
    if ints:
        grads = rng.integers(-8, 9, (N, D)).astype(dtype)
    else:
        grads = rng.standard_normal((N, D)).astype(dtype)
    return ids, grads


@pytest.mark.parametrize("ints", [True, False], ids=["ints", "random"])
def test_hot_onehot_push_vs_pallas_and_segment_sum(ints):
    H = 256
    ids, grads = _push_inputs(4, H=H, ints=ints)
    got = hot_onehot_push(torch.from_numpy(ids), torch.from_numpy(grads), H)
    assert got.dtype == torch.float32 and got.shape == (H, 128)
    pal = np.asarray(pallas_push(jnp.asarray(ids), jnp.asarray(grads),
                                 num_rows=H, block_rows=64, interpret=True))
    seg = np.asarray(jax.ops.segment_sum(jnp.asarray(grads),
                                         jnp.asarray(ids), num_segments=H))
    if ints:
        np.testing.assert_array_equal(got.numpy(), pal)
        np.testing.assert_array_equal(got.numpy(), seg)
    else:
        tol = 1e-6 * hot_onehot_push_ref(torch.from_numpy(ids),
                                         torch.from_numpy(np.abs(grads)),
                                         H).numpy()
        assert (np.abs(got.numpy() - pal) <= tol).all()
        assert (np.abs(got.numpy() - seg) <= tol).all()


def test_hot_onehot_push_bf16_grads_no_block_rule_and_empty():
    # bf16 grads sum in f32; num_rows = 300 is no multiple of 512 or of
    # the Pallas block, which the port does not need
    H = 300
    rng = np.random.default_rng(5)
    ids = rng.integers(-20, H + 20, 500).astype(np.int64)
    g = jnp.asarray(rng.integers(-4, 5, (500, 16)), jnp.bfloat16)
    got = hot_onehot_push(torch.from_numpy(ids), _to_torch(g), H)
    seg = jax.ops.segment_sum(g.astype(jnp.float32),
                              jnp.asarray(np.where(ids < 0, H, ids)),
                              num_segments=H)
    np.testing.assert_array_equal(got.numpy(), np.asarray(seg))
    # N = 0: zero rows
    z = hot_onehot_push(torch.zeros(0, dtype=torch.int32),
                        torch.zeros((0, 16)), 7)
    assert z.shape == (7, 16) and not z.any()


def _segment_case(name, seed):
    """(ids, num_rows, D) at the shapes the kernel's grouping must take:
    every num_rows a multiple of 64, so the Pallas kernel's block rule
    holds at block_rows=64."""
    rng = np.random.default_rng(seed)
    if name == "hot id at 2000 positions":     # 63 pieces of 32
        N, H, D = 2600, 128, 64
        ids = rng.integers(0, H, N)
        ids[rng.permutation(N)[:2000]] = 17
    elif name == "D=513":                      # dfm's width, 4-byte rows
        N, H, D = 1500, 256, 513
        ids = rng.integers(0, H, N)
    elif name == "num_rows > N":               # most rows empty
        N, H, D = 300, 1024, 16
        ids = rng.integers(0, H, N)
    else:                                      # 10% out of range
        N, H, D = 2000, 192, 40
        ids = rng.integers(0, H, N)
        bad = rng.random(N) < 0.1
        ids[bad] = np.where(rng.random(bad.sum()) < 0.5, -3, H + 9)
    return ids, H, D


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", ["hot id at 2000 positions", "D=513",
                                  "num_rows > N", "10% out of range"])
def test_hot_onehot_push_segment_shapes_vs_segment_sum_and_pallas(
        case, id_dtype, name):
    """Integer grads (exact sums) bit for bit against `segment_sum` and the
    Pallas kernel in interpret mode; random grads within 1e-6 * sum|g|."""
    jdt, tdt = DTYPES[name]
    ids, H, D = _segment_case(case, 11)
    rng = np.random.default_rng(12)
    tids = torch.from_numpy(ids).to(id_dtype)
    seg_ids = jnp.asarray(np.where(ids < 0, H, ids))   # drop, not wrap
    g = jnp.asarray(rng.integers(-8, 9, (len(ids), D)), jdt)
    got = hot_onehot_push(tids, _to_torch(g), H)
    assert got.dtype == torch.float32 and got.shape == (H, D)
    seg = jax.ops.segment_sum(g.astype(jnp.float32), seg_ids,
                              num_segments=H)
    pal = pallas_push(jnp.asarray(ids), g, num_rows=H, block_rows=64,
                      interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(seg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))
    gr = jnp.asarray(rng.standard_normal((len(ids), D)), jdt)
    got = hot_onehot_push(tids, _to_torch(gr), H).numpy()
    grf = gr.astype(jnp.float32)
    want = np.asarray(jax.ops.segment_sum(grf, seg_ids, num_segments=H))
    tol = 1e-6 * np.asarray(jax.ops.segment_sum(jnp.abs(grf), seg_ids,
                                                num_segments=H))
    assert (np.abs(got - want) <= tol).all()


def _grouping(ids, num_rows):
    """What the kernel's allocation makes of ids: (warp units, block
    pieces, long segments). A segment of at most WARP_ROWS positions (an
    empty one too) is a warp unit; a longer one is ceil(L / PIECE) block
    pieces, and long if L > PIECE."""
    valid = ids[(ids >= 0) & (ids < num_rows)]
    L = np.bincount(valid, minlength=num_rows)
    big = L > WARP_ROWS
    return (int((~big).sum()), int((-(-L[big] // PIECE)).sum()),
            int((L > PIECE).sum()))


@pytest.mark.parametrize("case", ["one id", "all segments of 33",
                                  "all segments of 5", "zipf", "empty",
                                  "num_rows > N"])
def test_hot_onehot_push_scratch_bounds_hold(case):
    """`scratch_sizes` sizes the kernel's scratch from N and num_rows
    alone (the host never reads the ids): its bounds must hold for the
    ids that come closest to them."""
    rng = np.random.default_rng(13)
    n, H = 33 * 5 * 40, 4096
    ids = {"one id": np.full(n, 7),
           "all segments of 33": np.repeat(np.arange(n // 33), 33),
           "all segments of 5": np.repeat(np.arange(n // 5), 5),
           "zipf": np.minimum(rng.zipf(1.2, n) - 1, H - 1),
           "empty": np.full(n, -1),
           "num_rows > N": rng.permutation(H)[:n // 4]}[case]
    n = len(ids)
    zeroed, plain, partial_rows = scratch_sizes(n, H)
    max_long = zeroed - 4 - H                  # cursors, counts, tickets
    max_pieces = (plain - 2 * n - H) // 4 - H - max_long
    assert max_pieces == partial_rows
    units, pieces, n_long = _grouping(rng.permutation(ids), H)
    assert units <= H and pieces <= max_pieces and n_long <= max_long
    if case == "all segments of 33":           # the long bound is tight
        assert n_long == max_long
    if case == "all segments of 5":            # and the piece bound
        assert pieces == max_pieces


# ----------------------------------------------------------------------
# ops built on K2 and K3
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_segment_sum_grads_matches_jax(name):
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(6)
    inv = rng.integers(0, 40, (16, 26)).astype(np.int32)
    g = jnp.asarray(rng.integers(-8, 9, (16, 26, 8)), jdt)   # exact sums
    jinv = jnp.asarray(inv.reshape(-1))                 # JAX takes it flat
    want = jax_segment_sum(g, jinv, 40)
    got = segment_sum_grads(_to_torch(g), torch.from_numpy(inv), 40)
    assert got.dtype == tdt and got.shape == (40, 8)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    gf = rng.standard_normal((16 * 26, 8)).astype(np.float32)
    want = np.asarray(jax_segment_sum(jnp.asarray(gf), jinv, 40))
    got = segment_sum_grads(torch.from_numpy(gf), torch.from_numpy(inv), 40)
    tol = 1e-6 * np.asarray(jax_segment_sum(jnp.abs(jnp.asarray(gf)),
                                            jinv, 40))
    assert (np.abs(got.numpy() - want) <= tol).all()


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_scatter_add_rows_with_duplicates_matches_jax(name):
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(7)
    R, D = 200, 8
    rows = rng.integers(0, R + 10, 150)           # duplicates, some >= R
    if name == "bf16":
        # dyadic table and values: every sum is exact in bf16
        table = jnp.asarray(rng.integers(-64, 64, (R, D)) / 64, jdt)
        vals = rng.integers(-8, 9, (150, D)).astype(np.float32) / 16
    else:
        table = jnp.asarray(rng.standard_normal((R, D)), jdt)
        vals = rng.standard_normal((150, D)).astype(np.float32)
    want = np.asarray(jax_scatter_add_rows(
        table, jnp.asarray(rows), jnp.asarray(vals).astype(jdt)).astype(
            jnp.float32))
    tt = _to_torch(table)
    out = scatter_add_rows(tt, torch.from_numpy(rows),
                           torch.from_numpy(vals).to(tdt))
    assert out is tt and out.dtype == tdt
    if name == "bf16":
        np.testing.assert_array_equal(out.float().numpy(), want)
    else:
        absum = np.zeros((R, D), np.float32)
        ok = rows < R
        np.add.at(absum, rows[ok], np.abs(vals[ok]))
        tol = 1e-6 * (absum + np.abs(np.asarray(table)))
        assert (np.abs(out.numpy() - want) <= tol).all()


def test_launch_counters_stay_put_on_the_cpu():
    before = {k: f.launches for k, f in KERNELS.items()}
    ids, grads = _push_inputs(8, H=64, D=8, N=40)
    hot_onehot_push(torch.from_numpy(ids), torch.from_numpy(grads), 64)
    rows_scatter_add(torch.zeros(64, 8), torch.arange(8),
                     torch.ones(8, 8))
    segment_sum_grads(torch.ones(4, 8), torch.tensor([0, 1, 1, 3]), 4)
    scatter_add_rows(torch.zeros(8, 8), torch.tensor([1, 1]),
                     torch.ones(2, 8))
    gather_pool_rows(torch.ones(8, 4), torch.tensor([[1, 2, 9]]),
                     torch.tensor([0, 1, 3], dtype=torch.int32))
    hot_onehot_push(torch.tensor([0, 1, 1]), torch.ones(2, 8), 4,
                    torch.tensor([0, 1, 1], dtype=torch.int32))
    assert set(KERNELS) == {"embedding_gather", "gather_pool_rows",
                            "hot_onehot_gather", "hot_onehot_gather_add_",
                            "hot_onehot_push", "rows_scatter_add",
                            "fm_second_order", "fm_second_order_backward",
                            "unique_fill"}
    assert {k: f.launches for k, f in KERNELS.items()} == before


def test_cuda_wrappers_refuse_mixed_devices():
    # a CPU tensor beside a CUDA one never falls back to the plain version
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    t = torch.zeros(8, 4, device="cuda")
    with pytest.raises(ValueError, match="one card"):
        rows_scatter_add(t, torch.arange(2), torch.ones(2, 4, device="cuda"))
    with pytest.raises(ValueError, match="one card"):
        hot_onehot_push(torch.arange(2), torch.ones(2, 4, device="cuda"), 4)


def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(chip_smoke.py runs these checks on the card)")
    for name in ("f32", "bf16"):
        _, tdt = DTYPES[name]
        ids, grads = _push_inputs(9, ints=True)
        i = torch.from_numpy(ids).cuda()
        g = torch.from_numpy(grads).cuda().to(tdt)
        a = hot_onehot_push(i, g, 256)
        assert torch.equal(a, hot_onehot_push_ref(i, g, 256))
        assert torch.equal(a, hot_onehot_push(i, g, 256))   # deterministic
        t = torch.randn(104, 128, device="cuda").to(tdt)
        u = torch.tensor([3, 7, 42, 99, 0, 55], device="cuda")
        d = torch.randn(6, 128, device="cuda")
        want = rows_scatter_add_ref(t.clone(), u, d)
        assert torch.equal(rows_scatter_add(t, u, d), want)
    torch.cuda.synchronize()
