"""The plain reference against the port at a small size on the CPU: the
same tower on the same weights and rows gives the same logits, and the
reference's SGD step moves what the port's does."""

import pytest
import torch
from conftest import ROOT

from portbench import gen, harness
from portbench.reference import precision, train


@pytest.mark.parametrize("name,model", [("wdl", "wdl_criteo"),
                                        ("dfm", "dfm_criteo")])
def test_tower_matches_the_port(name, model):
    from herald_tpu_torch.models.base import get_model
    cfg = {"num_sparse": 26, "num_dense": 13, "embedding_dim": 16,
           "tower": {"widths": [256, 256, 256] if name == "wdl"
                     else [256, 256, 1], "init_std": 0.01}}
    ref = harness.load_module(ROOT / "portbench" / "reference" /
                              f"{name}.py", f"ref_{name}")
    params = gen.tower(ref.shapes(cfg), 0.01, 3, "cpu")
    port = get_model(model)
    shapes = {k: tuple(v.shape) for k, v in port.init_dense(
        torch.Generator().manual_seed(0), 16).items()}
    assert shapes == {k: tuple(v) for k, v in ref.shapes(cfg).items()}
    g = torch.Generator().manual_seed(1)
    emb = 0.01 * torch.randn((8, 26, ref.width(cfg)), generator=g)
    dense = torch.randn((8, 13), generator=g)
    want = port.apply(params, emb, dense)
    got = ref.logits(params, emb, dense, precision.MATMUL["float32"])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-9)


def test_sgd_step_moves_touched_rows_only():
    cfg = {"num_sparse": 2, "num_dense": 3, "embedding_dim": 4,
           "tower": {"widths": [8, 8, 8], "init_std": 0.1}}
    ref = harness.load_module(ROOT / "portbench" / "reference" / "wdl.py",
                              "ref_wdl_sgd")
    tower = gen.tower(ref.shapes(cfg), 0.1, 0, "cpu")
    ids = torch.tensor([[1, 5], [1, 7]])
    union = torch.tensor([1, 5, 7, 9])
    rows = (torch.randn((4, 4)) * 0.1).to(torch.float32)
    state = train.State(tower, union, rows)
    batch = train.Batch(torch.randn((2, 3)), ids,
                        torch.tensor([[1.0], [0.0]]))
    new, loss = train.step(ref, state, batch, 1.0, precision.MATMUL[
        "float32"])
    assert torch.equal(new.rows[3], rows[3])
    assert not torch.equal(new.rows[0], rows[0])
    assert all(not torch.equal(new.tower[k], tower[k]) for k in tower)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10, -1.5])
    y = precision.to_tf32(x)
    assert y.tolist() == [1.0, 1.0 + 2**-9, 1.0 + 2**-10, -1.5]
