"""The port's row-sharded exchange (`herald_tpu_torch/parallel/exchange.py`)
and its collectives (`parallel/comm.py`) against herald_tpu's exchange on
S = 2 and 4 ranks.

The port's side runs on S spawned CPU processes of one gloo group (the
kernels' plain versions; `tests/_ranks.py`), each rank writing what it
computed; JAX's side runs the same inputs through `shard_map` on the
first S of the 8 CPU devices of `tests/conftest.py`. The rank functions
import torch only: JAX is imported in the test bodies.

Tolerances: routing (each unique id's slot, the received ids, the
overflow count), the owner's unique local rows, their mask and counts,
the gathered rows and int8 quantization are compared exactly. Summed
gradients differ only in the order of the sum: f32 within rtol 1e-6,
atol 1e-7 on all three wires (a bf16 or int8 wire carries the same
values in both packages); bf16 gradients within 2^-7 of the value plus
2^-13, since JAX adds them in bf16, one rounding per addition, where the
port adds in f32 and rounds once (the bound `tests/test_torch_train.py`
states for the bf16 table).
"""

import numpy as np
import pytest
import torch

from _ranks import run_ranks
from herald_tpu_torch.parallel import comm as C
from herald_tpu_torch.parallel import exchange as ex

ROWS, DIM, U = 1024, 8, 32
# (grads dtype, wire dtype, with counts)
SCATTER = [("f32", None, False), ("f32", None, True), ("f32", "bf16", False),
           ("f32", "int8", False), ("f32", "int8", True), ("bf16", None, False)]
_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
          None: None}


# ---------------------------------------------------------------------------
# inputs, made with numpy from seeds on every rank and in the test
# ---------------------------------------------------------------------------
def _table():
    return np.random.default_rng(0).standard_normal(
        (ROWS, DIM)).astype(np.float32)


def _spec(S, capacity=None):
    return ex.make_exchange(ROWS, S, U, capacity=capacity)


def _gather_ids(S):
    """Each rank's sorted distinct ids, then 4 padding slots of -1 (the
    engine's static dedup); ids may repeat across ranks."""
    rng = np.random.default_rng(10 + S)
    ids = np.full((S, U), -1, np.int32)
    for r in range(S):
        ids[r, :U - 4] = np.sort(rng.choice(ROWS, U - 4, replace=False))
    return ids


def _overflow_ids(S):
    """Every rank asks for 6 rows of shard 0 (ids congruent 0 mod S) and
    has 2 padding slots: with capacity 2, 4 are dropped on each."""
    ids = np.tile(np.arange(8, dtype=np.int32) * S, (S, 1))
    ids[:, -2:] = -1
    return ids


def _scatter_inputs(S):
    """Overlapping ids across ranks, duplicates within a rank masked to -1
    and sorted (so the -1 come first), grads and counts zero there."""
    rng = np.random.default_rng(1 + S)
    ids = np.sort(rng.integers(0, ROWS, size=(S, U)).astype(np.int32), 1)
    for r in range(S):
        row = ids[r]
        row[np.concatenate([[False], row[1:] == row[:-1]])] = -1
        ids[r] = np.sort(row)
    grads = rng.standard_normal((S, U, DIM)).astype(np.float32)
    grads[ids < 0] = 0
    counts = rng.integers(1, 4, size=(S, U)).astype(np.int32)
    counts[ids < 0] = 0
    return ids, grads, counts


def _scatter_name(case):
    return "scatter_" + "_".join(str(c) for c in case)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _exchange_rank(rank, S, init, out):
    torch.set_num_threads(1)
    comm = C.setup("cpu", init_method=init, rank=rank, world_size=S)
    assert (comm.rank, comm.size, comm.backend) == (rank, S, "gloo")
    res = {}
    table = torch.from_numpy(_table())
    for name, ids, spec in (
            ("gather", _gather_ids(S), _spec(S)),
            ("route", _gather_ids(S), _spec(S, capacity=3)),
            ("overflow", _overflow_ids(S), _spec(S, capacity=2))):
        uniq = torch.from_numpy(ids[rank])
        route = ex.route_ids(spec, uniq, uniq >= 0, comm)
        block = spec.block_of(table, rank)
        res[name] = {"rows": ex.gather_rows(spec, block, route, comm),
                     "pos": route.pos, "recv": route.recv_ids,
                     "overflow": route.overflow}
    ids, grads, counts = _scatter_inputs(S)
    spec = _spec(S)
    for case in SCATTER:
        gdt, wire, with_counts = case
        uniq = torch.from_numpy(ids[rank])
        route = ex.route_ids(spec, uniq, uniq >= 0, comm)
        g = torch.from_numpy(grads[rank]).to(_TORCH[gdt])
        rows_idx, row_grads, row_counts, row_mask = ex.scatter_grads(
            spec, route, g, comm,
            counts_uniq=torch.from_numpy(counts[rank]) if with_counts
            else None,
            wire_dtype=_TORCH[wire])
        assert row_grads.dtype == g.dtype
        assert (row_counts is None) != with_counts
        res[_scatter_name(case)] = {
            "rows_idx": rows_idx, "row_grads": row_grads,
            "row_mask": row_mask,
            **({"row_counts": row_counts} if with_counts else {})}
    # the collectives themselves
    coll = {}
    for dt in (torch.float32, torch.bfloat16, torch.int8, torch.int32,
               torch.int64, torch.uint8):
        x = (torch.arange(S * 6) + 10 * rank).to(dt).view(S, 6)
        coll[f"a2a_{dt}".replace("torch.", "")] = comm.all_to_all(x)
    coll["all_reduce"] = comm.all_reduce_(torch.full((5,), rank + 1.0))
    coll["all_gather"] = comm.all_gather(torch.full((3,), float(rank)))
    ts = [torch.full((2,), float(rank)), torch.full((3,), rank + 7),
          torch.full((4,), rank + 2.0)]
    comm.broadcast_(ts)
    coll["broadcast"] = torch.cat([t.float() for t in ts])
    res["collectives"] = coll
    torch.save({k: {n: _np(t) for n, t in v.items()} for k, v in res.items()},
               out / f"r{rank}.pt")


@pytest.fixture(scope="module", params=[2, 4], ids=lambda s: f"S{s}")
def ranks(request, tmp_path_factory):
    """(S, [each rank's results]) of one run of `_exchange_rank`."""
    S = request.param
    out = tmp_path_factory.mktemp(f"exchange{S}")
    run_ranks(_exchange_rank, S, out, out)
    return S, [torch.load(out / f"r{r}.pt", weights_only=False)
               for r in range(S)]


# ---------------------------------------------------------------------------
# JAX's side
# ---------------------------------------------------------------------------
def _jax_spec(S, capacity):
    from herald_tpu.parallel import exchange as jex
    return jex.ExchangeSpec(axis="dp", num_shards=S,
                            rows_per_shard=_spec(S).rows_per_shard,
                            num_rows=ROWS, capacity=capacity)


def _shard_map(S, f, n_in, n_out):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    mesh = Mesh(np.array(jax.devices()[:S]), ("dp",))
    return jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P("dp"),) * n_in,
        out_specs=(P("dp"),) * n_out, check_vma=False))


def _jax_gather(S, ids, capacity):
    """Per rank: (rows [U, D], pos [U], recv_ids [S, C], overflow)."""
    from herald_tpu.parallel import exchange as jex
    spec = _jax_spec(S, capacity)

    def f(table_shard, uniq):
        route = jex.route_ids(spec, uniq, uniq >= 0)
        return (jex.gather_rows(spec, table_shard, route), route.pos,
                route.recv_ids, route.overflow.reshape(1))

    phys = spec.to_physical(_table())
    rows, pos, recv, over = (np.asarray(a) for a in _shard_map(S, f, 2, 4)(
        phys, ids.reshape(-1)))
    n = ids.shape[1]
    return (rows.reshape(S, n, DIM), pos.reshape(S, n),
            recv.reshape(S, S, capacity), over)


def _check_gather(S, res, name, ids, capacity):
    rows, pos, recv, over = _jax_gather(S, ids, capacity)
    for r in range(S):
        got = res[r][name]
        np.testing.assert_array_equal(got["pos"], pos[r])
        np.testing.assert_array_equal(got["recv"], recv[r])
        assert int(got["overflow"]) == int(over[r])
        np.testing.assert_array_equal(got["rows"], rows[r])
    return rows, over


def test_gather_matches_dense_lookup_and_jax(ranks):
    S, res = ranks
    ids = _gather_ids(S)
    rows, over = _check_gather(S, res, "gather", ids, _spec(S).capacity)
    assert (over == 0).all()
    want = np.where((ids >= 0)[..., None], _table()[ids], 0)
    for r in range(S):
        np.testing.assert_array_equal(res[r]["gather"]["rows"], want[r])


def test_route_overflow_drops_the_ids_jax_drops(ranks):
    """At capacity 3 the ids beyond each owner's first 3 (in JAX's stable
    order) are dropped: the same ids, slots and counts in both."""
    S, res = ranks
    _, over = _check_gather(S, res, "route", _gather_ids(S), 3)
    assert over.sum() > 0


def test_gather_handles_padding_and_overflow(ranks):
    S, res = ranks
    rows, over = _check_gather(S, res, "overflow", _overflow_ids(S), 2)
    assert (over == 4).all()       # 6 real ids, 2 served, 4 dropped
    for r in range(S):
        got = res[r]["overflow"]["rows"].reshape(8, DIM)
        ids = _overflow_ids(S)[r]
        np.testing.assert_array_equal(got[:2], _table()[ids[:2]])
        assert (got[2:] == 0).all()


@pytest.mark.parametrize("case", SCATTER, ids=_scatter_name)
def test_scatter_grads_match_jax(ranks, case):
    import jax.numpy as jnp
    from herald_tpu.parallel import exchange as jex
    S, res = ranks
    gdt, wire, with_counts = case
    spec = _jax_spec(S, _spec(S).capacity)
    ids, grads, counts = _scatter_inputs(S)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}

    def f(uniq, g, cnt):
        route = jex.route_ids(spec, uniq, uniq >= 0)
        rows_idx, row_grads, row_counts, row_mask = jex.scatter_grads(
            spec, route, g, counts_uniq=cnt if with_counts else None,
            wire_dtype=jdt[wire] if wire else None)
        if row_counts is None:
            row_counts = jnp.zeros_like(rows_idx)
        return rows_idx, row_grads.astype(jnp.float32), row_counts, row_mask

    SC = S * spec.capacity
    out = _shard_map(S, f, 3, 4)(ids.reshape(-1),
                                 jnp.asarray(grads.reshape(-1, DIM),
                                             jdt[gdt]),
                                 counts.reshape(-1))
    rows_idx, row_grads, row_counts, row_mask = (np.asarray(a) for a in out)
    tol = (dict(rtol=2.0 ** -7, atol=2.0 ** -13) if gdt == "bf16"
           else dict(rtol=1e-6, atol=1e-7))
    for r in range(S):
        got = res[r][_scatter_name(case)]
        sl = slice(r * SC, (r + 1) * SC)
        np.testing.assert_array_equal(got["rows_idx"], rows_idx[sl])
        np.testing.assert_array_equal(got["row_mask"], row_mask[sl])
        np.testing.assert_allclose(got["row_grads"], row_grads[sl], **tol)
        if with_counts:
            np.testing.assert_array_equal(got["row_counts"], row_counts[sl])
    if (gdt, wire) == ("f32", None):
        # the dense scatter-add oracle of tests/test_exchange.py
        expect = np.zeros((ROWS, DIM), np.float32)
        for r in range(S):
            for i in range(U):
                if ids[r, i] >= 0:
                    expect[ids[r, i]] += grads[r, i]
        shard = np.zeros((spec.padded_rows, DIM), np.float32)
        for r in range(S):
            got = res[r][_scatter_name(case)]
            keep = got["row_mask"]
            shard[r * spec.rows_per_shard + got["rows_idx"][keep]] += \
                got["row_grads"][keep]
        np.testing.assert_allclose(shard, spec.to_physical(expect),
                                   rtol=1e-5, atol=1e-5)


def test_collectives(ranks):
    S, res = ranks
    for r in range(S):
        got = res[r]["collectives"]
        for dt in ("float32", "bfloat16", "int8", "int32", "int64", "uint8"):
            # block j came from rank j: its r-th block of 6
            want = np.stack([np.arange(S * 6)[r * 6:(r + 1) * 6] + 10 * j
                             for j in range(S)])
            np.testing.assert_array_equal(got[f"a2a_{dt}"], want)
        np.testing.assert_array_equal(got["all_reduce"],
                                      np.full(5, S * (S + 1) / 2))
        np.testing.assert_array_equal(
            got["all_gather"], np.repeat(np.arange(S)[:, None], 3, 1))
        np.testing.assert_array_equal(got["broadcast"],
                                      [0, 0, 7, 7, 7, 2, 2, 2, 2])


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows,S,ids,factor,capacity", [
    (4096, 1, 416, 2.0, None), (1203, 2, 416, 2.0, None),
    (33_762_577, 2, 6656, 2.0, None), (3000, 4, 416, 8.0, None),
    (1000, 8, 20, 2.0, None), (1000, 4, 64, 0.1, None),
    (1000, 2, 64, 2.0, 17)])
def test_make_exchange_matches_jax(rows, S, ids, factor, capacity):
    from herald_tpu.parallel import exchange as jex
    want = jex.make_exchange(rows, S, ids, capacity_factor=factor,
                             capacity=capacity)
    got = ex.make_exchange(rows, S, ids, capacity_factor=factor,
                           capacity=capacity)
    assert (got.num_shards, got.rows_per_shard, got.num_rows, got.capacity,
            got.padded_rows) == (want.num_shards, want.rows_per_shard,
                                 want.num_rows, want.capacity,
                                 want.padded_rows)


def test_strided_index_maps_roundtrip():
    """The maps are mutually consistent and JAX's; `block_of` gives each
    rank's block of `to_physical`."""
    from herald_tpu.parallel import exchange as jex
    spec = ex.ExchangeSpec(num_shards=8, rows_per_shard=16, num_rows=120,
                           capacity=4)
    jspec = jex.ExchangeSpec(axis="dp", num_shards=8, rows_per_shard=16,
                             num_rows=120, capacity=4)
    r = np.arange(spec.num_rows)
    p = spec.phys_index(r)
    assert len(np.unique(p)) == spec.num_rows
    assert (p < spec.padded_rows).all()
    np.testing.assert_array_equal(spec.logical_index(p), r)
    np.testing.assert_array_equal(
        p, spec.owner_of(r) * spec.rows_per_shard + spec.local_of(r))
    np.testing.assert_array_equal(p, jspec.phys_index(r))
    np.testing.assert_array_equal(spec.logical_index(np.arange(128)),
                                  jspec.logical_index(np.arange(128)))
    t = np.random.default_rng(0).standard_normal((spec.num_rows, 3))
    np.testing.assert_array_equal(spec.to_logical(spec.to_physical(t)), t)
    np.testing.assert_array_equal(spec.to_physical(t), jspec.to_physical(t))
    # a logical table with padding rows past num_rows, as the one-device
    # engine holds it
    tt = torch.from_numpy(np.concatenate([t, np.ones((8, 3))]))
    phys = spec.to_physical(t)
    for rank in range(8):
        np.testing.assert_array_equal(
            spec.block_of(tt, rank).numpy(), phys[rank * 16:(rank + 1) * 16])
    # torch ids map as numpy ids
    np.testing.assert_array_equal(spec.phys_index(torch.from_numpy(r)), p)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_rowquant_int8_bit_for_bit(dt):
    import jax.numpy as jnp
    from herald_tpu.parallel import exchange as jex
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((64, 13))
         * rng.uniform(1e-3, 10, (64, 1))).astype(np.float32)
    x[3] = 0                            # a zero row: scale 1
    x[5, :] = np.arange(13) - 6         # integers: ties on .5 after /scale
    x[7, 0] = -0.0
    jq, jsc = jex.rowquant_int8(jnp.asarray(x, {"f32": jnp.float32,
                                                "bf16": jnp.bfloat16}[dt]))
    q, sc = ex.rowquant_int8(torch.from_numpy(x).to(_TORCH[dt]))
    assert q.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sc.numpy().view(np.int32),
                                  np.asarray(jsc).view(np.int32))


def test_one_rank_exchange_routes_locally():
    """At S = 1 the collectives return their inputs (JAX's `_all_to_all`),
    every id is routed to the one shard, and the gather reads the table."""
    spec = ex.make_exchange(ROWS, 1, U)
    assert spec.capacity == U and spec.padded_rows == 1024
    comm = C.Comm(0, 1, torch.device("cpu"), None)
    x = torch.arange(6).view(1, 6)
    assert comm.all_to_all(x) is x
    assert comm.all_reduce_(x) is x
    assert torch.equal(comm.all_gather(x), x[None])
    ids = torch.from_numpy(_gather_ids(1)[0])
    for c in (None, comm):
        route = ex.route_ids(spec, ids, ids >= 0, c)
        assert int(route.overflow) == 0
        rows = ex.gather_rows(spec, torch.from_numpy(_table()), route, c)
        want = np.where((ids >= 0).numpy()[:, None],
                        _table()[ids.numpy()], 0)
        np.testing.assert_array_equal(rows.numpy(), want)


@pytest.mark.parametrize("device,shared,backend", [
    ("cpu", False, "gloo"), ("cpu", True, "gloo"),
    ("cuda:0", False, "nccl"), ("cuda:0", True, "gloo")])
def test_backend_rule(device, shared, backend):
    assert C.choose_backend(torch.device(device), shared) == backend


def test_setup_without_a_group(monkeypatch):
    """No group and no torch.distributed.run environment: one rank, no
    backend; the world size follows WORLD_SIZE; a missing card raises."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    c = C.setup("cpu")
    assert (c.rank, c.size, c.backend, c.device) == (0, 1, None,
                                                     torch.device("cpu"))
    assert C.world_size() == 1
    monkeypatch.setenv("WORLD_SIZE", "3")
    assert C.world_size() == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            C.rank_device(None, 0)
        with pytest.raises(RuntimeError, match="does not exist"):
            C.rank_device("cuda:1", 1)
