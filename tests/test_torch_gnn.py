"""The port's GCN (`herald_tpu_torch/gnn/`) on one rank against
herald_tpu's, at `tests/test_gnn.py`'s size: 240 nodes, 3 classes, 12
features, hidden 8.

The graph helpers are host numpy and must give JAX's arrays bit for bit.
The model runs on the CPU, where K1 and K3 take their plain versions.
Tolerances: the logits of every mode within rtol 1e-5, atol 1e-5 of
JAX's (f32 sums in another order) and within 1e-4 of the float64 dense
oracle (`test_gnn.py`'s); 3 SGD steps' losses within 1e-5 and
parameters within rtol 1e-5, atol 1e-6. The autograd Functions are held
to `torch.autograd.gradcheck` in float64 on the plain route, with K3's
plain version kept in float64 (the kernel's contract is f32 out).
"""

import numpy as np
import pytest
import torch

from herald_tpu_torch import bridge
from herald_tpu_torch import gnn as T
from herald_tpu_torch.gnn import gcn as tgcn
from herald_tpu_torch.ops.embedding import unique_fill
from herald_tpu_torch.parallel import comm as C
from herald_tpu_torch.parallel import exchange as tex

MODES = ("halo", "pull", "broadcast")
SBM = dict(num_nodes=240, num_classes=3, feat_dim=12, noise=2.5, seed=3)


@pytest.fixture(scope="module")
def graphs():
    from herald_tpu.gnn import synthetic_sbm
    return synthetic_sbm(**SBM), T.synthetic_sbm(**SBM)


def _jax_spec(n, S, ids):
    from herald_tpu.parallel.exchange import make_exchange
    return make_exchange(n, S, ids_per_step=ids)


def dense_forward(g, params):
    """Oracle: Z = relu(Ā H W1 + b1) ... in float64 numpy."""
    a = g.dense_adjacency().astype(np.float64)
    h = g.features.astype(np.float64)
    for i, (w, b) in enumerate(params):
        h = a @ (h @ np.asarray(w, np.float64)) + np.asarray(b, np.float64)
        if i + 1 < len(params):
            h = np.maximum(h, 0.0)
    return h


def _np_params(m):
    return [(w.detach().cpu().numpy(), b.detach().cpu().numpy())
            for w, b in m.params]


def test_synthetic_sbm_is_jaxs_bit_for_bit(graphs):
    jg, tg = graphs
    for f in ("src", "dst", "weight", "features", "labels", "train_mask",
              "eval_mask"):
        a, b = getattr(jg, f), getattr(tg, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert jg.num_nodes == tg.num_nodes
    np.testing.assert_array_equal(jg.dense_adjacency(),
                                  tg.dense_adjacency())


def test_normalize_edges_matches_jax():
    from herald_tpu.gnn import normalize_edges
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 50, 200), rng.integers(0, 50, 200)
    for kw in ({}, {"add_self_loops": False}, {"symmetrize": False}):
        for a, b in zip(normalize_edges(50, src, dst, **kw),
                        T.normalize_edges(50, src, dst, **kw)):
            assert a.dtype == b.dtype and np.array_equal(a, b), kw
    s, d, w = T.normalize_edges(4, np.array([0, 1, 2]), np.array([1, 2, 3]))
    a = np.zeros((4, 4))
    np.add.at(a, (d, s), w)
    assert np.allclose(a, a.T) and np.all(np.diag(a) > 0)
    assert np.all(np.abs(np.linalg.eigvalsh(a)) <= 1 + 1e-6)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_partition_and_halo_plan_match_jax(graphs, S):
    from herald_tpu.gnn import partition_edges, plan_halo_exchange
    jg, tg = graphs
    js = _jax_spec(jg.num_nodes, S, jg.num_nodes)
    ts = tex.make_exchange(tg.num_nodes, S, tg.num_nodes)
    for kw in ({}, {"edge_cap": None, "uniq_cap": 7}):
        a, b = partition_edges(js, jg, **kw), T.partition_edges(ts, tg, **kw)
        for f in ("src", "dst_local", "weight"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (f, kw)
        assert (a.edge_cap, a.uniq_cap) == (b.edge_cap, b.uniq_cap)
    loose = T.partition_edges(ts, tg, edge_cap=b.edge_cap + 33)
    assert np.array_equal(partition_edges(js, jg, edge_cap=a.edge_cap
                                          + 33).src, loose.src)
    assert (loose.src[:, -33:] == tg.num_nodes).all()
    assert (loose.dst_local[:, -33:] == ts.rows_per_shard).all()
    assert (loose.weight[:, -33:] == 0).all()
    pa, pb = plan_halo_exchange(js, jg, a), T.plan_halo_exchange(ts, tg, b)
    for f in ("send_slot", "edge_vec_idx"):
        x, y = getattr(pa, f), getattr(pb, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (pa.halo_cap, pa.halo_rows) == (pb.halo_cap, pb.halo_rows)
    with pytest.raises(ValueError, match="edge_cap"):
        T.partition_edges(ts, tg, edge_cap=1)


def test_locality_reorder_and_relabel_match_jax(graphs):
    from herald_tpu.gnn import locality_reorder, relabel_graph
    jg, tg = graphs
    for S in (2, 8):
        a, b = locality_reorder(jg, S), T.locality_reorder(tg, S)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        ja, tb = relabel_graph(jg, a), T.relabel_graph(tg, b)
        assert ja.num_nodes == tb.num_nodes
        for f in ("src", "dst", "weight", "features", "labels",
                  "train_mask", "eval_mask"):
            x, y = getattr(ja, f), getattr(tb, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert sorted(b.tolist()) == sorted(set(b.tolist()))


@pytest.mark.parametrize("S", [1, 8])
def test_shard_node_array_matches_jax_and_round_trips(graphs, S):
    from herald_tpu.gnn import shard_node_array
    jg, tg = graphs
    js, ts = _jax_spec(jg.num_nodes, S, 16), tex.make_exchange(
        tg.num_nodes, S, 16)
    for x, fill in ((tg.features, 0), (tg.labels, 0),
                    (tg.train_mask.astype(np.float32), 0),
                    (tg.labels, -1)):
        a, b = shard_node_array(js, x, fill), T.shard_node_array(ts, x, fill)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    back = ts.to_logical(T.shard_node_array(ts, tg.features))
    np.testing.assert_array_equal(back, tg.features)


def test_init_gcn_params_equal_jaxs():
    from herald_tpu.gnn import GCNConfig, init_gcn_params
    for kw in ({}, {"num_layers": 3, "seed": 7}):
        a = init_gcn_params(GCNConfig(12, 8, 3, **kw))
        b = T.init_gcn_params(T.GCNConfig(12, 8, 3, **kw))
        assert len(a) == len(b)
        for (jw, jb), (tw, tb) in zip(a, b):
            assert tw.dtype == torch.float32 and tb.dtype == torch.float32
            np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
            np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
        bridged = bridge.gcn_params_from_jax(a)
        for (jw, jb), (tw, tb) in zip(a, bridged):
            np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
            np.testing.assert_array_equal(np.asarray(jb), tb.numpy())


def test_unique_fill_is_jnp_unique():
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    for n, hi, size in ((40, 10, 6), (40, 10, 16), (64, 200, 50), (8, 3, 8)):
        ids = rng.integers(0, hi, n).astype(np.int32)
        ju, ji = jnp.unique(ids, size=size, fill_value=hi,
                            return_inverse=True)
        tu, ti = unique_fill(torch.from_numpy(ids), size, hi)
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
        np.testing.assert_array_equal(np.asarray(ji).reshape(-1), ti.numpy())


@pytest.mark.parametrize("mode", MODES)
def test_logits_match_jax_and_dense_oracle(graphs, mode):
    from herald_tpu.gnn import GCN, GCNConfig
    jg, tg = graphs
    jm = GCN(GCNConfig(feat_dim=12, hidden_dim=8, num_classes=3, seed=1),
             jg, mode=mode)
    tm = T.GCN(T.GCNConfig(12, 8, 3, seed=1), tg, mode=mode, device="cpu")
    tm.load_params(bridge.gcn_params_from_jax(jm.params))
    got = tm.logits()
    assert got.shape == (240, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jm.logits()), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got, dense_forward(tg, _np_params(tm)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_three_sgd_steps_match_jax(graphs, mode):
    from herald_tpu.gnn import GCN, GCNConfig
    jg, tg = graphs
    jm = GCN(GCNConfig(feat_dim=12, hidden_dim=8, num_classes=3,
                       learning_rate=0.3, seed=2), jg, mode=mode)
    tm = T.GCN(T.GCNConfig(12, 8, 3, learning_rate=0.3, seed=2), tg,
               mode=mode, device="cpu")
    for step in range(3):
        jl, jo = jm.train_step()
        tl, to = tm.train_step()
        assert jo == 0 and to == 0
        assert abs(jl - tl) < 1e-5, (step, jl, tl)
    for (jw, jb), (tw, tb) in zip(jm.params, _np_params(tm)):
        np.testing.assert_allclose(tw, np.asarray(jw), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tb, np.asarray(jb), rtol=1e-5, atol=1e-6)
    assert tm.accuracy("eval") == pytest.approx(jm.accuracy("eval"))
    assert tm.accuracy("train") == pytest.approx(jm.accuracy("train"))


def _f64_push(ids, grads, num_rows):
    """K3's plain version without its f32 cast, for gradcheck."""
    valid = (ids >= 0) & (ids < num_rows)
    out = grads.new_zeros((num_rows, grads.shape[1]))
    return out.index_add_(0, ids[valid], grads[valid])


@pytest.mark.parametrize("fn", ["aggregate", "pull", "halo", "broadcast"])
def test_autograd_functions_pass_gradcheck(monkeypatch, fn):
    monkeypatch.setattr(tgcn, "hot_onehot_push", _f64_push)
    gen = torch.Generator().manual_seed(0)
    rows = torch.randn(12, 3, dtype=torch.float64, generator=gen,
                       requires_grad=True)
    one = C.Comm(0, 1, torch.device("cpu"), None)
    if fn == "aggregate":
        # indices past the rows (zero rows) and a pad destination (dropped)
        idx = torch.tensor([0, 3, 3, 11, 12, 5, 7, 2])
        dst = torch.tensor([0, 0, 1, 2, 2, 3, 4, 5])
        w = torch.rand(8, dtype=torch.float64, generator=gen)

        def f(x):
            return tgcn.Aggregate.apply(x, idx, w, dst, 5)
    elif fn == "pull":
        # the shard's 16 rows (12 padded to 8s), 3 distinct ids and the pad
        spec = tex.make_exchange(12, 1, 6)
        uniq = torch.tensor([1, 4, 4, 9, 12, 12], dtype=torch.int32)
        uniq, _ = unique_fill(uniq, 6, 12)
        route = tex.route_ids(spec, uniq, uniq < 12)

        def f(x):
            return tgcn.PullRows.apply(x, spec, route, None)
        rows = torch.randn(spec.rows_per_shard, 3, dtype=torch.float64,
                           generator=gen, requires_grad=True)
    elif fn == "halo":
        # one rank: the "received" rows are its own, read at the slots
        send = torch.tensor([[2, 5, 12, 5]])

        def f(x):
            return tgcn.HaloTable.apply(x, send, one)
    else:
        def f(x):
            return tgcn.GatherAll.apply(x, one)
    assert torch.autograd.gradcheck(f, (rows,))


def test_convergence_beats_feature_only_baseline(graphs):
    _, g = graphs
    m = T.GCN(T.GCNConfig(12, 16, 3, learning_rate=0.5, seed=0), g,
              device="cpu").fit(epochs=60)
    acc = m.accuracy("eval")
    assert acc > 0.85, acc
    tr = g.train_mask
    x = np.concatenate([g.features, np.ones((g.num_nodes, 1), np.float32)],
                       1)
    y = np.eye(3)[g.labels]
    wls, *_ = np.linalg.lstsq(x[tr], y[tr], rcond=None)
    base = ((x[~tr] @ wls).argmax(1) == g.labels[~tr]).mean()
    assert acc > base + 0.05, (acc, base)


def test_gcn_needs_a_device_without_a_card(graphs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.GCN(T.GCNConfig(12, 8, 3), graphs[1])
    with pytest.raises(ValueError, match="mode"):
        T.GCN(T.GCNConfig(12, 8, 3), graphs[1], mode="ring", device="cpu")
