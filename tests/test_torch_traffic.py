"""Collective-traffic accounting of the port (`parallel/comm.py`'s
`Comm.bytes`, `utils/hlo_stats.py`), the engines' `example_step_args` and
`utils/graphboard.py`, against herald_tpu's `tests/test_traffic_hlo.py`
and `tests/test_smoke.py::test_graphboard_emits_graphs`.

Over S = 2 gloo ranks (one module-scoped spawn, `tests/_ranks.py`) on
wdl_criteo at `test_traffic_hlo.py`'s shapes (batch 16 a rank, 32,768
rows, embedding 8), the all-to-all bytes counted over one plain hybrid
step and one cached hybrid step equal the analytic model
`exchange_a2a_bytes` over the port's exchanges, whose capacities equal
JAX's engines' on a 2-device mesh, and equal what JAX's compiled steps
move. The port's id wire is int32, as JAX's: 4 bytes an id.
"""

import numpy as np
import pytest
import torch

from _ranks import run_ranks
from herald_tpu_torch import Engine, HeraldConfig
from herald_tpu_torch.parallel import comm as C
from herald_tpu_torch.train.cached import CachedEngine
from herald_tpu_torch.train.graphs import feed_inputs, unpack
from herald_tpu_torch.utils import graphboard
from herald_tpu_torch.utils.hlo_stats import (collective_bytes,
                                              exchange_a2a_bytes)

S = 2
B = 16
ROWS = 32768
EMB = 8
BATCHES = 20
WIRES = {"f32": None, "bf16": torch.bfloat16, "int8": torch.int8}


def _cfgs(sparse):
    """The plain engine's config (pull capacity from the baseline traffic
    profile, as `test_traffic_hlo.py` sizes it) and the cached one's."""
    from herald_tpu_torch.sched.sizing import profile_baseline_traffic
    prof = profile_baseline_traffic(sparse, B, S)
    plain = dict(model="wdl_criteo", batch_size=B, embedding_dim=EMB,
                 comm_mode="hybrid", learning_rate=0.05,
                 a2a_pull_capacity=prof.pull_capacity())
    cached = dict(model="wdl_criteo", batch_size=B, embedding_dim=EMB,
                  comm_mode="hybrid", learning_rate=0.05, use_cache=True,
                  cache_limit=int(0.25 * ROWS))
    return plain, cached


def _data():
    from herald_tpu_torch.data import synthetic_ctr_data
    from herald_tpu_torch.models import get_model
    return synthetic_ctr_data(get_model("wdl_criteo").spec,
                              B * S * BATCHES, seed=11, num_rows=ROWS)


def _shapes(a: dict) -> dict:
    return {k: (tuple(v.shape), v.dtype) for k, v in a.items()}


def _traffic_rank(rank, S_, init, out):
    """Counted bytes of one plain and one cached step per flush wire, the
    exchanges' capacities, a real step's bytes against the zero args', the
    args' shapes against a staged step's, and each Comm call's count.
    Imports no JAX."""
    torch.set_num_threads(1)
    comm = C.setup("cpu", init_method=init, rank=rank, world_size=S_)
    dense, sparse, labels = _data()
    plain, cached = _cfgs(sparse)
    res = {}
    eng = Engine(HeraldConfig(**plain), table_rows=ROWS, device="cpu")
    st = eng.init_state(0)
    args = eng.example_step_args()
    res["plain"] = {
        "bytes": collective_bytes(eng._train_step_body, st, *args,
                                  comm=eng.comm),
        "capacity": eng.exchange.capacity, "width": eng.width,
        "args": _shapes(args[0])}
    gb = B * S_
    before = dict(eng.comm.bytes)
    eng.train_step(st, dense[:gb], sparse[:gb], labels[:gb])
    res["plain"]["real_step"] = {k: v - before.get(k, 0)
                                 for k, v in eng.comm.bytes.items()}
    res["plain"]["fed"] = _shapes(feed_inputs(eng._batch_feed({
        "d": (dense[:gb], np.float32), "s": (sparse[:gb], np.int32),
        "y": (labels[:gb], np.float32)}), eng.device))
    try:
        graphboard.step_graph(eng)
        res["graph_refused"] = None
    except ValueError as e:
        res["graph_refused"] = str(e)
    for name, wire in WIRES.items():
        ce = CachedEngine(HeraldConfig(**cached, flush_wire_dtype=wire),
                          table_rows=ROWS, device="cpu")
        cst = ce.init_cached_state(0)
        a, variant = ce.example_step_args()
        res[name] = {
            "bytes": collective_bytes(ce._cached_step_body, cst, a, variant,
                                      comm=ce.comm),
            "pull_capacity": ce.exchange.capacity,
            "flush_capacity": ce.flush_exchange.capacity,
            "args": _shapes(a), "variant": variant}
        if name == "f32":
            planner = ce.make_planner(sparse, epochs=1, n_threads=1)
            staged = ce._stage_chunk(*planner.pop_chunk(1), raw_dense=dense,
                                     raw_sparse=sparse, raw_labels=labels,
                                     index_feed=False)
            planner.close()
            res[name]["staged"] = _shapes(unpack(staged.packed[0],
                                                 staged.layout))
    # one call of each collective
    x = torch.arange(5, dtype=torch.float32)
    counted = {}
    for kind, fn in (
            ("all-reduce", lambda: comm.all_reduce_(x.clone())),
            ("all-gather", lambda: comm.all_gather(x[:3])),
            ("reduce-scatter", lambda: comm.reduce_scatter(
                torch.ones(2 * S_))),
            ("collective-broadcast", lambda: comm.broadcast_(
                [torch.zeros(4, dtype=torch.int32), torch.zeros(2)])),
            ("collective-permute", lambda: comm.send(
                torch.zeros(6, dtype=torch.int64), 1) if rank == 0
             else comm.recv_(torch.empty(6, dtype=torch.int64), 0))):
        counted[kind] = collective_bytes(fn, comm=comm)
    res["calls"] = counted
    torch.save(res, out / f"traffic.r{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("traffic")
    run_ranks(_traffic_rank, S, out, out, timeout=240.0)
    return [torch.load(out / f"traffic.r{r}.pt", weights_only=False)
            for r in range(S)]


def _jax_engines(wire=None):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from herald_tpu import HeraldConfig as JaxConfig
    from herald_tpu.train.cached import CachedEngine as JaxCached
    from herald_tpu.train.engine import Engine as JaxEngine
    from herald_tpu.data import synthetic_ctr_data
    from herald_tpu.models import get_model
    _, sparse, _ = synthetic_ctr_data(get_model("wdl_criteo").spec,
                                      B * S * BATCHES, seed=11,
                                      num_rows=ROWS)
    plain, cached = _cfgs(sparse)
    mesh = Mesh(np.array(jax.devices()[:S]), ("dp",))
    jwire = {None: None, torch.bfloat16: jnp.bfloat16,
             torch.int8: jnp.int8}[wire]
    return (JaxEngine(JaxConfig(**plain), mesh=mesh, table_rows=ROWS),
            JaxCached(JaxConfig(**cached, flush_wire_dtype=jwire),
                      mesh=mesh, table_rows=ROWS))


def test_plain_step_bytes_equal_the_capacity_model_and_jax(ranks):
    from herald_tpu.utils.hlo_stats import collective_bytes as jax_bytes
    jeng, _ = _jax_engines()
    W = ranks[0]["plain"]["width"]
    for r in ranks:
        p = r["plain"]
        assert p["capacity"] == jeng.exchange.capacity
        spec = jeng.exchange
        # ids (int32) out, table rows (f32) back, grads (f32) out
        want = exchange_a2a_bytes(spec, id_bytes=4, vec_bytes=W * 4,
                                  directions=2)
        assert p["bytes"]["all-to-all"] == want, (p["bytes"], want)
        assert p["bytes"]["count"]["all-to-all"] == 3
        # a real batch moves what the zero args move
        assert p["real_step"]["all-to-all"] == want
        assert p["real_step"]["all-reduce"] == p["bytes"]["all-reduce"]
    st = jeng.init_state(0)
    hlo = jax_bytes(jeng._train_step, st, *jeng.example_step_args())
    assert hlo["all-to-all"] == ranks[0]["plain"]["bytes"]["all-to-all"]


@pytest.mark.parametrize("wire", list(WIRES))
def test_cached_step_bytes_equal_the_capacity_model(ranks, wire):
    _, jc = _jax_engines(WIRES[wire])
    W = ranks[0]["plain"]["width"]
    vec = {"f32": 4 * W, "bf16": 2 * W, "int8": W + 4}[wire]
    for r in ranks:
        c = r[wire]
        assert c["pull_capacity"] == jc.exchange.capacity
        assert c["flush_capacity"] == jc.flush_exchange.capacity
        # the pull: ids out, f32 rows back; the flush: ids out, deltas on
        # the flush wire (int8: the payload and a f32 scale a row)
        pull = exchange_a2a_bytes(jc.exchange, id_bytes=4, vec_bytes=4 * W,
                                  directions=1)
        flush = exchange_a2a_bytes(jc.flush_exchange, id_bytes=4,
                                   vec_bytes=vec, directions=1)
        assert c["bytes"]["all-to-all"] == pull + flush, (c["bytes"], pull,
                                                          flush)
        assert c["bytes"]["count"]["all-to-all"] == (5 if wire == "int8"
                                                     else 4)
        assert c["variant"] == (True, False, True, False, False)


def test_cached_step_bytes_equal_jaxs_compiled_step(ranks):
    from herald_tpu.utils.hlo_stats import collective_bytes as jax_bytes
    _, jc = _jax_engines()
    st = jc.init_cached_state(0)
    hlo = jax_bytes(jc._cached_step, st, *jc.example_step_args())
    assert hlo["all-to-all"] == ranks[0]["f32"]["bytes"]["all-to-all"]


def test_each_collective_counts_its_result_buffer(ranks):
    for r, res in enumerate(ranks):
        c = res["calls"]
        assert c["all-reduce"]["all-reduce"] == 5 * 4
        assert c["all-gather"]["all-gather"] == S * 3 * 4
        assert c["reduce-scatter"]["reduce-scatter"] == 2 * 4
        assert c["collective-broadcast"]["collective-broadcast"] == 4 * 4 \
            + 2 * 4
        assert c["collective-broadcast"]["count"] == {
            "collective-broadcast": 2}
        assert c["collective-permute"]["collective-permute"] == 6 * 8
        for kind, got in c.items():
            assert sum(got[k] for k in got if k != "count") == got[kind]
            assert set(got["count"]) == {kind}


def test_one_rank_counts_nothing():
    one = C.Comm(0, 1, torch.device("cpu"), None)
    x = torch.ones(4)
    got = collective_bytes(lambda: (one.all_reduce_(x), one.all_gather(x),
                                    one.reduce_scatter(x),
                                    one.all_to_all(x.view(1, 4)),
                                    one.broadcast_([x])), comm=one)
    assert all(v == 0 for k, v in got.items() if k != "count")
    assert got["count"] == {} and one.bytes == {}


def test_example_step_args_are_what_the_steps_take(ranks):
    for r in ranks:
        assert r["plain"]["args"] == r["plain"]["fed"]
        assert r["f32"]["args"] == r["f32"]["staged"]
    cfg = HeraldConfig(model="wdl_criteo", batch_size=8, embedding_dim=8)
    eng = Engine(cfg, table_rows=500, device="cpu")
    d, s, y = (np.zeros((8, 13), np.float32), np.zeros((8, 26), np.int32),
               np.zeros((8, 1), np.float32))
    fed = feed_inputs(eng._batch_feed({"d": (d, np.float32),
                                       "s": (s, np.int32),
                                       "y": (y, np.float32)}), eng.device)
    args = eng.example_step_args()
    assert len(args) == 1 and _shapes(args[0]) == _shapes(fed)
    st, loss = eng._train_step_body(eng.init_state(0), *args)
    assert loss.shape == () and torch.isfinite(loss)
    ce = CachedEngine(HeraldConfig(model="wdl_criteo", batch_size=8,
                                   embedding_dim=8, cache_limit=100,
                                   pinned_rows=16),
                      table_rows=500, device="cpu")
    a, variant = ce.example_step_args()
    assert "uniq" in a and variant == (False, False, True, False, False)
    cst, loss = ce._cached_step_body(ce.init_cached_state(0), a, variant)
    assert torch.isfinite(loss)


def test_graphboard_emits_dot_and_refuses_xla_formats(tmp_path, ranks):
    cfg = HeraldConfig(model="wdl_criteo", batch_size=8, embedding_dim=8,
                       comm_mode="local")
    eng = Engine(cfg, table_rows=500, device="cpu")
    dot = graphboard.step_graph(eng, fmt="dot")
    assert dot.startswith("digraph")
    assert "aten.mm" in dot and "->" in dot and dot.rstrip().endswith("}")
    for fmt in ("stablehlo", "hlo_opt"):
        with pytest.raises(ValueError, match="'dot'"):
            graphboard.step_graph(eng, fmt=fmt)
    path = graphboard.save(eng, str(tmp_path / "step.dot"))
    assert open(path).read() == dot
    # over several ranks the step's collectives would leave the trace
    assert "one-rank engine" in ranks[0]["graph_refused"]
