"""The port's GCN over S = 2 and 4 gloo ranks against herald_tpu's GCN on
a mesh of the first S CPU devices, at `tests/test_gnn.py`'s size.

One module-scoped spawn per S (`tests/_ranks.py`) runs every case on the
ranks, which import torch only and write what they computed; the tests
then build JAX's models in this process. Every rank builds the model
from the whole graph and keeps its own nodes and edges; `logits()`
returns every node's logits on every rank.

Tolerances: logits within rtol 1e-5, atol 1e-5 of JAX's and 1e-4 of the
float64 dense oracle; 3 SGD steps' losses within 1e-5 and parameters
within rtol 1e-5, atol 1e-6 (f32 sums in another order). Across modes
and relabelings the port is held as `test_gnn.py` holds JAX: broadcast
equals pull within 1e-5, padding edges change no logit beyond 1e-5, and
a relabeled graph's logits equal the original's within 1e-4.
"""

import numpy as np
import pytest
import torch

from _ranks import run_ranks
from test_torch_gnn import dense_forward

MODES = ("halo", "pull", "broadcast")
SBM = dict(num_nodes=240, num_classes=3, feat_dim=12, noise=2.5, seed=3)
STEPS = 3
TIGHT = 0.05        # a capacity factor that drops pull ids at S = 2, 4


def _gnn_rank(rank, S, init, out):
    """Every case on one rank: the modes' logits, steps and bytes, the
    broadcast/pull pair, loose edge padding, the relabeled graph and a
    tight exchange. Imports no JAX."""
    torch.set_num_threads(1)
    from herald_tpu_torch import gnn as T
    from herald_tpu_torch.parallel import comm as C
    from herald_tpu_torch.utils.hlo_stats import collective_bytes
    comm = C.setup("cpu", init_method=init, rank=rank, world_size=S)
    g = T.synthetic_sbm(**SBM)
    res = {"rank": rank}
    for mode in MODES:
        m = T.GCN(T.GCNConfig(12, 8, 3, seed=1), g, comm=comm, mode=mode)
        first = m.logits()
        m = T.GCN(T.GCNConfig(12, 8, 3, learning_rate=0.3, seed=2), g,
                  comm=comm, mode=mode)
        steps = [m.train_step() for _ in range(STEPS)]
        res[mode] = {
            "logits": first, "steps": steps,
            "params": [(w.detach().clone().numpy(),
                        b.detach().clone().numpy()) for w, b in m.params],
            "acc": (m.accuracy("eval"), m.accuracy("train")),
            "bytes": collective_bytes(m.step, comm=comm),
            "halo_rows": m.plan.halo_rows if m.plan else None}
    # broadcast against pull, one model each from one seed
    mp = T.GCN(T.GCNConfig(12, 8, 3, seed=5), g, comm=comm, mode="pull")
    mb = T.GCN(T.GCNConfig(12, 8, 3, seed=5), g, comm=comm,
               mode="broadcast")
    res["pair"] = {"pull": mp.logits(), "broadcast": mb.logits(),
                   "losses": (mp.train_step()[0], mb.train_step()[0])}
    # loose edge padding in pull mode: the same model, 33 more pad edges
    m = T.GCN(T.GCNConfig(12, 8, 3, seed=4), g, comm=comm, mode="pull")
    base = m.logits()
    loose = T.partition_edges(m.spec, g, edge_cap=m.sharded.edge_cap + 33)
    m.sharded = loose
    for k, a in (("src", loose.src), ("dst_local", loose.dst_local),
                 ("weight", loose.weight)):
        m._data[k] = torch.as_tensor(a[rank])
    res["padding"] = {"tight": base, "loose": m.logits()}
    # the locality relabeling: same logits, smaller halo
    new_id = T.locality_reorder(g, S)
    g2 = T.relabel_graph(g, new_id)
    m1 = T.GCN(T.GCNConfig(12, 8, 3, seed=6), g, comm=comm)
    m2 = T.GCN(T.GCNConfig(12, 8, 3, seed=6), g2, comm=comm)
    res["reorder"] = {"new_id": new_id, "logits": m1.logits(),
                      "relabeled": m2.logits(),
                      "halo_rows": (m1.plan.halo_rows, m2.plan.halo_rows),
                      "bytes": (collective_bytes(m1.step, comm=comm),
                                collective_bytes(m2.step, comm=comm))}
    # a tight pull exchange: the overflow, summed over the ranks; fit raises
    m = T.GCN(T.GCNConfig(12, 8, 3, seed=7), g, comm=comm,
              capacity_factor=TIGHT, mode="pull")
    _, ovf = m.train_step()
    _, route = T.gcn._dedup_and_route(m.spec, m._data["src"],
                                      m.sharded.uniq_cap, comm)
    try:
        m.fit(epochs=2)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    res["overflow"] = {"step": ovf, "mine": int(route.overflow),
                       "capacity": m.spec.capacity, "raised": raised}
    torch.save(res, out / f"gnn.r{rank}.pt")


def _spawn(S, tmp_path_factory):
    out = tmp_path_factory.mktemp(f"gnn{S}")
    run_ranks(_gnn_rank, S, out, out, timeout=240.0)
    return [torch.load(out / f"gnn.r{r}.pt", weights_only=False)
            for r in range(S)]


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return _spawn(2, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _spawn(4, tmp_path_factory)


@pytest.fixture(scope="module")
def graph():
    from herald_tpu.gnn import synthetic_sbm
    return synthetic_sbm(**SBM)


@pytest.fixture
def ranks(request):
    return request.getfixturevalue(f"ranks{request.param}")


def _mesh(S):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:S]), ("dp",))


def _same_on_every_rank(res, *keys):
    def pick(r):
        x = r
        for k in keys:
            x = x[k]
        return x
    first = pick(res[0])
    for r in res[1:]:
        got = pick(r)
        if isinstance(first, np.ndarray):
            np.testing.assert_array_equal(got, first)
        elif isinstance(first, list) and first and isinstance(first[0],
                                                               tuple):
            for a, b in zip(got, first):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
        else:
            assert got == first, keys
    return first


@pytest.mark.parametrize("ranks,mode", [(S, m) for S in (2, 4)
                                        for m in MODES],
                         indirect=["ranks"])
def test_logits_match_jax_and_dense_oracle(ranks, mode, graph):
    from herald_tpu.gnn import GCN, GCNConfig
    S = len(ranks)
    got = _same_on_every_rank(ranks, mode, "logits")
    jm = GCN(GCNConfig(feat_dim=12, hidden_dim=8, num_classes=3, seed=1),
             graph, mesh=_mesh(S), mode=mode)
    assert got.shape == (240, 3)
    np.testing.assert_allclose(got, np.asarray(jm.logits()), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got, dense_forward(graph, jm.params),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ranks,mode", [(S, m) for S in (2, 4)
                                        for m in MODES],
                         indirect=["ranks"])
def test_three_sgd_steps_match_jax(ranks, mode, graph):
    from herald_tpu.gnn import GCN, GCNConfig
    S = len(ranks)
    steps = _same_on_every_rank(ranks, mode, "steps")
    params = _same_on_every_rank(ranks, mode, "params")
    jm = GCN(GCNConfig(feat_dim=12, hidden_dim=8, num_classes=3,
                       learning_rate=0.3, seed=2), graph, mesh=_mesh(S),
             mode=mode)
    for step, (tl, to) in enumerate(steps):
        jl, jo = jm.train_step()
        assert jo == 0 and to == 0
        assert abs(jl - tl) < 1e-5, (step, jl, tl)
    for (jw, jb), (tw, tb) in zip(jm.params, params):
        np.testing.assert_allclose(tw, np.asarray(jw), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tb, np.asarray(jb), rtol=1e-5, atol=1e-6)
    acc = _same_on_every_rank(ranks, mode, "acc")
    assert acc == pytest.approx((jm.accuracy("eval"),
                                 jm.accuracy("train")))


@pytest.mark.parametrize("ranks", [2, 4], indirect=True)
def test_broadcast_mode_matches_pull(ranks):
    pair = ranks[0]["pair"]
    np.testing.assert_allclose(pair["broadcast"], pair["pull"], rtol=1e-5,
                               atol=1e-5)
    assert abs(pair["losses"][0] - pair["losses"][1]) < 1e-5


@pytest.mark.parametrize("ranks", [2, 4], indirect=True)
def test_edge_padding_invariance(ranks):
    for r in ranks:
        np.testing.assert_allclose(r["padding"]["loose"],
                                   r["padding"]["tight"], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("ranks", [2, 4], indirect=True)
def test_locality_reorder_preserves_logits_and_cuts_halo(ranks, graph):
    from herald_tpu.gnn import locality_reorder
    S = len(ranks)
    ro = ranks[0]["reorder"]
    np.testing.assert_array_equal(ro["new_id"], locality_reorder(graph, S))
    np.testing.assert_allclose(ro["relabeled"][ro["new_id"]], ro["logits"],
                               rtol=1e-4, atol=1e-4)
    before, after = ro["halo_rows"]
    assert after < before, ro["halo_rows"]
    # the halo's all-to-all carries the plan's padded width both ways
    b1, b2 = ro["bytes"]
    assert b2["all-to-all"] < b1["all-to-all"], (b1, b2)


@pytest.mark.parametrize("ranks", [2, 4], indirect=True)
def test_collective_bytes_per_mode(ranks):
    """Counted bytes a step on each rank: pull's routed ids and rows both
    ways, halo's planned rows both ways, broadcast's all-gather and
    reduce-scatter; one all-reduce of the train count and one of the
    grads, the loss and the overflow."""
    S = len(ranks)
    n_params = 12 * 8 + 8 * 3 + 8 + 3
    for r in ranks:
        for mode in MODES:
            b = r[mode]["bytes"]
            assert b["all-reduce"] == 4 + 4 * (n_params + 2), (mode, b)
            assert b["count"]["all-reduce"] == 2
        assert r["broadcast"]["bytes"]["all-to-all"] == 0
        assert r["broadcast"]["bytes"]["count"]["all-gather"] == 2
        assert r["broadcast"]["bytes"]["count"]["reduce-scatter"] == 2
        assert r["halo"]["bytes"]["all-gather"] == 0
        assert r["pull"]["bytes"]["count"]["all-to-all"] == 5
    per = -(-240 // S)
    rps = -(-per // 8) * 8
    bc = ranks[0]["broadcast"]["bytes"]
    # layer 1 gathers [S*rps, 8] f32 and scatters it back; layer 2, width 3
    assert bc["all-gather"] == S * rps * (8 + 3) * 4
    assert bc["reduce-scatter"] == rps * (8 + 3) * 4


@pytest.mark.parametrize("ranks", [2, 4], indirect=True)
def test_overflow_is_summed_over_ranks_and_fit_raises(ranks, graph):
    from herald_tpu.gnn import GCN, GCNConfig
    S = len(ranks)
    mine = [r["overflow"]["mine"] for r in ranks]
    assert all(m > 0 for m in mine)
    for r in ranks:
        assert r["overflow"]["step"] == sum(mine)
        assert "exchange overflow" in r["overflow"]["raised"]
    # JAX's step returns one shard's count (its out_specs P() of a
    # per-shard value): rank 0's here
    jm = GCN(GCNConfig(feat_dim=12, hidden_dim=8, num_classes=3, seed=7),
             graph, mesh=_mesh(S), capacity_factor=TIGHT, mode="pull")
    assert jm.spec.capacity == ranks[0]["overflow"]["capacity"]
    assert jm.train_step()[1] == mine[0]
    with pytest.raises(RuntimeError, match="exchange overflow"):
        jm.fit(epochs=2)
