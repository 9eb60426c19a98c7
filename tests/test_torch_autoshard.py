"""The port's layout search (`parallel/autoshard.py`) over a gloo group of
4 CPU ranks (`tests/_ranks.py`, one spawn), mirroring
`tests/test_autoshard.py`: the audit table's structure (every mp that
divides S, the all-to-all bytes independent of mp and equal to JAX's
search over 4 CPU devices, a positive roofline, the choice its argmin),
a model without a TP tower searched at mp = 1 alone with its refusals
listed, and the chosen layout training. The FLOPs are the matrix
products `FlopCounterMode` counts; the defaults are the H100's rates.
"""

import inspect

import numpy as np
import pytest
import torch

from _ranks import run_ranks
from herald_tpu_torch.parallel import autoshard

S = 4


def _search_rank(rank, S_, init, out):
    torch.set_num_threads(1)
    from herald_tpu_torch import Engine
    from herald_tpu_torch.data import synthetic_ctr_data
    from herald_tpu_torch.models import get_model
    from herald_tpu_torch.parallel import comm as C
    C.setup("cpu", init_method=init, rank=rank, world_size=S_)
    res = {}
    res["wdl"] = autoshard.search_layout("wdl_criteo", batch_size=32,
                                         embedding_dim=16, table_rows=4096,
                                         device="cpu")
    res["dc"] = autoshard.search_layout("dc_criteo", batch_size=32,
                                        embedding_dim=16, table_rows=4096,
                                        device="cpu")
    cfg, _ = autoshard.search_layout("dfm_criteo", batch_size=8,
                                     embedding_dim=8, table_rows=2048,
                                     device="cpu")
    eng = Engine(cfg, table_rows=2048, device="cpu")
    d, s, y = synthetic_ctr_data(get_model(cfg.model).spec,
                                 S_ * cfg.batch_size, seed=1, num_rows=2048)
    _, stats = eng.train_step(eng.init_state(0), d, s, y)
    res["dfm"] = (cfg.mp_shards, float(stats["loss"]))
    torch.save(res, out / f"search.r{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("autoshard")
    run_ranks(_search_rank, S, out, out, timeout=240.0)
    return [torch.load(out / f"search.r{r}.pt", weights_only=False)
            for r in range(S)]


def test_search_audit_table_structure(ranks):
    from herald_tpu.parallel.autoshard import search_layout as jax_search
    _, jax_scores = jax_search("wdl_criteo", S, batch_size=32,
                               embedding_dim=16, table_rows=4096)
    jax_a2a = {s.a2a_bytes for s in jax_scores if s.valid}
    for rk in ranks:
        cfg, scores = rk["wdl"]
        valid = [s for s in scores if s.valid]
        assert {s.mp_shards for s in valid} == {1, 2, 4}
        # the embedding exchange is mp-independent (flat row sharding),
        # and equal to what JAX's compiled candidates move
        assert {s.a2a_bytes for s in valid} == jax_a2a
        assert len(jax_a2a) == 1
        assert all(s.step_us > 0 and s.comm_us > 0 and s.flops > 0
                   for s in valid)
        best = min(valid, key=lambda s: (s.step_us, s.mp_shards))
        assert cfg.mp_shards == best.mp_shards
        # a rank runs mp times the batch through 1/mp of each weight: the
        # same FLOPs at every mp (wdl has no replicated layer)
        assert len({s.flops for s in valid}) == 1
    assert all(rk["wdl"][1] == ranks[0]["wdl"][1] for rk in ranks)


def test_search_skips_unsupported_towers(ranks):
    for rk in ranks:
        cfg, scores = rk["dc"]
        assert cfg.mp_shards == 1
        invalid = [s for s in scores if not s.valid]
        assert invalid and all("no tensor-parallel tower" in s.reason
                               for s in invalid)
        assert [s.mp_shards for s in scores if s.valid] == [1]


def test_chosen_layout_runs(ranks):
    for rk in ranks:
        mp, loss = rk["dfm"]
        assert mp in (1, 2, 4) and np.isfinite(loss)


def test_defaults_are_the_h100s_and_main_prints_the_table(capsys):
    """The defaults are NVLink's 450 GB/s and the H100 SXM's f32 peak, and
    `main` on one rank prints JAX's audit table and the choice."""
    params = inspect.signature(autoshard.search_layout).parameters
    assert params["link_gbps"].default == 450.0
    assert params["peak_tflops"].default == 67.0
    autoshard.main(["wdl_criteo", "--batch-size", "32", "--embedding-size",
                    "16", "--rows", "4096", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split() == ["mp", "a2a", "B", "other", "B", "comm",
                                "us", "compute", "us", "step", "us"]
    assert lines[1].split()[:3] == ["1", "0", "0"]
    assert lines[-1] == "chosen: mp_shards=1"
