"""DLRM-DCNv2 (`herald_tpu_torch/models/dlrm.py`), the port's own
multi-hot model, against the benchmark's plain reference
(`portbench/reference/dlrm_dcnv2.py`, plain torch, imports nothing of the
port) on the CPU at a small size: a few rows a table, bags of 1 to 5,
embedding 8, batch 16, the published tower widths.

- the tower: logits, the dense gradients and the gradient of the rows by
  position, on seeded weights; `apply` (pools [B, P, W] itself) and
  `apply_pooled` agree;
- K1's pooled form: its plain version against K1 by position and a sum in
  position order, bit for bit (bags of one, an id outside the table, an id
  twice in a bag, -0.0 rows), and K3 through its position -> row map
  against K3 on the expanded gradient;
- `Engine.train_epoch` and `predict` against `reference/train.py`'s SGD:
  losses, the tower and the rows after 3 steps;
- the engines and paths that refuse multi-hot bags, and the launcher's
  plain branch for `--model dlrm_dcnv2_criteo1tb`.

Tolerances: logits and losses rtol 1e-5 (the two sum the products and the
bags in other orders, in f32); gradients and states rtol 1e-4 with an
absolute floor at 1e-5 of the tensor's largest element (elements that
cancel keep the error of the tensor's scale).
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from herald_tpu_torch import HeraldConfig
from herald_tpu_torch.data import (PORT_DATASETS, MultiHotSpec,
                                   dataset_for_model, synthetic_multihot_data)
from herald_tpu_torch.data.datasets import table_sizes_within
from herald_tpu_torch.launch import cli
from herald_tpu_torch.models import get_model
from herald_tpu_torch.models.dlrm import make_dlrm
from herald_tpu_torch.ops.embedding import segment_sum_grads
from herald_tpu_torch.ops.kernels import (embedding_gather_ref,
                                          gather_pool_rows,
                                          gather_pool_rows_ref,
                                          hot_onehot_push)
from herald_tpu_torch.ops.kernels.gather import pool_bags
from herald_tpu_torch.train.engine import Engine

ROOT = Path(__file__).resolve().parents[1]
BAGS = (1, 3, 2, 5, 1)
TABLES = (7, 50, 3, 20, 40)
W, B = 8, 16


def _load(name):
    path = ROOT / "portbench" / "reference" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"dlrm_ref_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("dlrm_dcnv2")
TRAIN = _load("train")
SPEC = MultiHotSpec("small", sum(BAGS), 13, sum(TABLES),
                    tuple(range(sum(BAGS))), len(BAGS), table_sizes=TABLES,
                    bag_sizes=BAGS)
MODEL = make_dlrm("dlrm_small", SPEC)
REF_CFG = {"embedding_dim": W, "num_dense": 13, "multi_hot_sizes": BAGS,
           "tower": {"bottom": [512, 256, W], "cross_layers": 3,
                     "cross_rank": 512, "top": [1024, 1024, 512, 256, 1]}}


def mm(a, b):
    return a @ b


class RefModel:
    def logits(self, p, emb, dense, mm):
        return REF.logits(p, emb, dense, mm, bags=BAGS)


def close(got, want, rtol=1e-4):
    atol = 1e-5 * float(want.abs().max()) + 1e-12
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def inputs(seed):
    g = torch.Generator().manual_seed(seed)
    params = MODEL.init_dense(g, W)
    emb = 0.3 * torch.randn((B, sum(BAGS), W), generator=g)
    dense = torch.randn((B, 13), generator=g)
    return params, emb, dense


def test_tower_shapes_are_the_references():
    got = {k: tuple(v.shape) for k, v in MODEL.init_dense(
        torch.Generator().manual_seed(0), W).items()}
    assert got == {k: tuple(v) for k, v in REF.shapes(REF_CFG).items()}
    assert list(got) == list(REF.shapes(REF_CFG))


@pytest.mark.parametrize("seed", [0, 1])
def test_logits_and_grads_match_the_reference(seed):
    params, emb, dense = inputs(seed)
    y = torch.randint(0, 2, (B,), generator=torch.Generator().manual_seed(
        seed)).float()

    def grads(fn):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        e = emb.clone().requires_grad_(True)
        logit = fn(p, e)
        loss = torch.nn.functional.binary_cross_entropy_with_logits(logit, y)
        return logit.detach(), torch.autograd.grad(loss, [*p.values(), e])

    lp, gp = grads(lambda p, e: MODEL.apply(p, e, dense))
    lr, gr = grads(lambda p, e: REF.logits(p, e, dense, mm, bags=BAGS))
    torch.testing.assert_close(lp, lr, rtol=1e-5, atol=1e-6)
    assert float(lr.std()) > 1e-3       # the logits carry the inputs
    for a, b in zip(gp, gr):
        close(a, b)


def test_apply_pools_as_apply_pooled_reads():
    params, emb, dense = inputs(2)
    pooled = pool_bags(emb, np.concatenate([[0], np.cumsum(BAGS)]))
    torch.testing.assert_close(MODEL.apply(params, emb, dense),
                               MODEL.apply_pooled(params, pooled, dense))
    ends = np.cumsum(BAGS)
    for k, (b, e) in enumerate(zip(BAGS, ends)):
        torch.testing.assert_close(pooled[:, k], emb[:, e - b:e].sum(1))


def _pool_case(dtype, id_dtype):
    g = torch.Generator().manual_seed(5)
    table = (0.1 * torch.randn((40, W), generator=g)).to(dtype)
    table[3] = -0.0
    ids = torch.randint(0, 40, (B, sum(BAGS)), generator=g)
    ids[0, :4] = torch.tensor([3, 41, -1, 9])      # -0.0, outside, outside
    ids[1, 1:4] = torch.tensor([9, 9, 9])          # one id three times
    off = torch.tensor(np.concatenate([[0], np.cumsum(BAGS)]),
                       dtype=torch.int32)
    return table, ids.to(id_dtype), off


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_pooled_k1_plain_version_sums_in_position_order(dtype, id_dtype):
    table, ids, off = _pool_case(dtype, id_dtype)
    got = gather_pool_rows(table, ids, off)
    assert got.dtype == torch.float32 and got.shape == (B, len(BAGS), W)
    rows = embedding_gather_ref(table, ids.reshape(-1), torch.float32
                                ).view(B, -1, W)
    o = off.tolist()
    for k, (a, b) in enumerate(zip(o, o[1:])):
        want = rows[:, a].clone()
        for j in range(a + 1, b):
            want = want + rows[:, j]
        assert torch.equal(got[:, k].view(torch.int32),
                           want.view(torch.int32)), k
    # a bag of one is K1 by position, -0.0 and the zero row included
    assert torch.equal(got[:, 0].view(torch.int32),
                       rows[:, 0].view(torch.int32))
    assert torch.signbit(got[0, 0]).all()
    # an id outside the table adds a zero row; one id three times, thrice
    torch.testing.assert_close(got[1, 1], 3 * rows[1, 1], rtol=1e-6,
                               atol=0)


def test_pooled_k1_refuses_offsets_that_do_not_cut_the_positions():
    table, ids, _ = _pool_case(torch.float32, torch.int32)
    for bad in ([0, 2, 5], [1, 3, 12], [0, 5, 3, 12]):
        with pytest.raises(ValueError, match="offsets"):
            gather_pool_rows(table, ids, torch.tensor(bad,
                                                      dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        gather_pool_rows_ref(table, ids, torch.tensor([0, 12]))


def test_mapped_k3_equals_k3_on_the_expanded_gradient():
    g = torch.Generator().manual_seed(6)
    nb = len(BAGS)
    pooled = torch.randn((B * nb, W), generator=g)
    ids = torch.randint(-1, 30, (B * sum(BAGS),), generator=g)
    bag_of = np.repeat(np.arange(nb), BAGS)
    rows = torch.tensor((np.arange(B)[:, None] * nb + bag_of).reshape(-1),
                        dtype=torch.int32)
    got = hot_onehot_push(ids, pooled, 30, rows)
    want = hot_onehot_push(ids, pooled.index_select(0, rows.long()), 30)
    assert torch.equal(got, want)
    torch.testing.assert_close(
        segment_sum_grads(pooled.view(B, nb, W), ids, 30, rows), want)


def _engine(lr=0.5):
    cfg = HeraldConfig(model="dlrm_small", batch_size=B, embedding_dim=W,
                       learning_rate=lr)
    return Engine(cfg, model=MODEL, table_rows=sum(TABLES), device="cpu")


def _data(n, seed=3):
    return synthetic_multihot_data(SPEC, n, seed=seed)


def test_train_epoch_matches_reference_sgd():
    eng = _engine()
    state = eng.init_state(4)
    R = sum(TABLES)
    rows0 = state.table[:R].clone()
    tower0 = {k: v.clone() for k, v in state.dense.items()}
    d, s, y = _data(3 * B)
    state, stats = eng.train_epoch(state, d, s, y, steps=3)
    batches = [TRAIN.Batch(torch.from_numpy(d[i * B:(i + 1) * B]),
                           torch.from_numpy(s[i * B:(i + 1) * B]),
                           torch.from_numpy(y[i * B:(i + 1) * B]))
               for i in range(3)]
    states, losses = TRAIN.run(RefModel(), TRAIN.State(
        tower0, torch.arange(R), rows0), batches, 0.5, mm)
    torch.testing.assert_close(stats["loss"], torch.tensor(losses),
                               rtol=1e-5, atol=0)
    for k in tower0:
        close(state.dense[k], states[-1].tower[k])
        assert not torch.equal(state.dense[k], tower0[k]), k
    close(state.table[:R] - rows0, states[-1].rows - rows0)
    touched = np.unique(s[:3 * B])
    assert not torch.equal(state.table[touched], rows0[touched])
    untouched = np.setdiff1d(np.arange(R), touched)
    assert torch.equal(state.table[untouched], rows0[untouched])


def test_predict_and_evaluate_score_the_reference():
    eng = _engine()
    state = eng.init_state(5)
    d, s, y = _data(2 * B, seed=8)
    got = eng.predict(state, d[:B], s[:B])
    emb = state.table[torch.from_numpy(s[:B])]
    want = torch.sigmoid(REF.logits(state.dense, emb, torch.from_numpy(
        d[:B]), mm, bags=BAGS))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
    res = eng.evaluate(state, d, s, y)
    assert 0.0 <= res["auc"] <= 1.0


def test_published_model_and_dataset():
    m = get_model("dlrm_dcnv2_criteo1tb")
    spec = dataset_for_model("dlrm_dcnv2_criteo1tb")
    assert spec is PORT_DATASETS["criteo1tb"] and m.spec is spec
    assert spec.num_sparse == sum(m.bags) == 214 and len(m.bags) == 26
    assert spec.num_embed_rows == 204_184_588 == m.table_rows
    assert spec.num_dense == 13
    shapes = {k: tuple(v.shape) for k, v in m.init_dense(
        torch.Generator().manual_seed(0), 128).items()}
    assert shapes["cross_V1"] == (3456, 512)
    assert shapes["cross_W3"] == (512, 3456)
    assert shapes["top_W1"] == (3456, 1024) and shapes["top_W5"] == (256, 1)
    assert shapes["bot_W1"] == (13, 512) and shapes["bot_W3"] == (256, 128)


def test_multihot_data_keeps_each_bag_in_its_table():
    sizes = table_sizes_within(SPEC, 60)
    assert sizes.sum() <= 60 and (sizes >= 1).all()
    assert table_sizes_within(SPEC).tolist() == list(TABLES)
    d, s, y = synthetic_multihot_data(SPEC, 200, seed=1, num_rows=60)
    assert s.shape == (200, sum(BAGS)) and d.shape == (200, 13)
    assert set(np.unique(y)) == {0.0, 1.0}
    lo = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    p = 0
    for t, bag in enumerate(BAGS):
        part = s[:, p:p + bag]
        assert part.min() >= lo[t] and part.max() < lo[t] + sizes[t]
        p += bag
    a = synthetic_multihot_data(SPEC, 50, seed=2)
    b = synthetic_multihot_data(SPEC, 50, seed=2)
    assert all(np.array_equal(x, z) for x, z in zip(a, b))


def test_multihot_rows_are_cut_by_the_configurations_hash_cap():
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / "dlrm_dcnv2_criteo1tb.json").read_text())
    spec = PORT_DATASETS["criteo1tb"]
    sizes = table_sizes_within(spec, cfg["table_rows"])
    assert sizes.tolist() == cfg["rows_per_table"]
    assert sizes.sum() == cfg["table_rows"] == 124_184_588
    # the cap: tables below it keep their rows, the rest hold the cap
    assert table_sizes_within(SPEC, 60).tolist() == [7, 16, 3, 16, 16]


@pytest.mark.parametrize("build", [
    lambda cfg: __import__("herald_tpu_torch.train.cached", fromlist=["x"]
                           ).CachedEngine(cfg, model=MODEL, table_rows=130,
                                          device="cpu"),
    lambda cfg: __import__("herald_tpu_torch.train.fae", fromlist=["x"]
                           ).FaeEngine(cfg, model=MODEL, table_rows=130,
                                       device="cpu"),
], ids=["cached", "fae"])
def test_one_id_a_field_engines_refuse_bags(build):
    cfg = HeraldConfig(model="dlrm_small", batch_size=B, embedding_dim=W)
    with pytest.raises(NotImplementedError, match="ROADMAP item 46"):
        build(cfg)


def test_onnx_export_refuses_bags():
    from herald_tpu_torch.onnx import export_inference
    params = MODEL.init_dense(torch.Generator().manual_seed(0), W)
    with pytest.raises(NotImplementedError, match="ROADMAP item 49"):
        export_inference(MODEL, params, torch.zeros((130, W)), "/dev/null")


ARGS = ["--model", "dlrm_dcnv2_criteo1tb", "--device", "cpu", "--samples",
        "400", "--rows", "3000", "--batch-size", "16", "--embedding-size",
        "8", "--nepoch", "1"]


def test_launcher_plain_branch_trains_dlrm():
    report = cli.run_training(cli.build_parser().parse_args(ARGS))
    assert report["model"] == "dlrm_dcnv2_criteo1tb"
    assert report["mode"] == "baseline" and report["steps"] == 22
    assert np.isfinite(report["train_loss_last"])
    assert report["val_auc"] is not None


@pytest.mark.parametrize("flag", ["--scheduled", "--fae"])
def test_launcher_refuses_dlrm_on_the_cached_and_fae_engines(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP item 46"):
        cli.run_training(cli.build_parser().parse_args(ARGS + [flag]))


def test_engine_refuses_bags_over_several_ranks():
    eng = _engine()
    eng.num_shards = 2
    with pytest.raises(NotImplementedError, match="ROADMAP item 45"):
        eng._init_bags()


def test_dedup_path_reads_the_pooled_gradient_through_the_map():
    """The table optimizers' dedup path (`_apply_sparse_grads`) takes the
    same map as the SGD fast path: with SGD on both, the same steps."""
    fast, dedup = _engine(), _engine()
    dedup._fast_local_sgd = False
    d, s, y = _data(2 * B, seed=11)
    a, _ = fast.train_epoch(fast.init_state(6), d, s, y, steps=2)
    b, _ = dedup.train_epoch(dedup.init_state(6), d, s, y, steps=2)
    close(b.table, a.table)
    for k in a.dense:
        close(b.dense[k], a.dense[k])
