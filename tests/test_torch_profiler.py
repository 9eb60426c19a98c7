"""The port's profiling utilities (`herald_tpu_torch/utils/profiler.py`):
`comm_stats` equals JAX's for the same configuration (the hybrid engine
on 1, 2 and 4 devices), and `trace` writes a Chrome trace of the block."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from herald_tpu_torch import Engine, HeraldConfig
from herald_tpu_torch.parallel.exchange import make_exchange
from herald_tpu_torch.utils.profiler import comm_stats, trace


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("model,factor", [("wdl_criteo", 2.0),
                                          ("dfm_criteo", 8.0)])
def test_comm_stats_equal_jax(S, model, factor):
    import jax
    from jax.sharding import Mesh
    from herald_tpu import HeraldConfig as JaxConfig
    from herald_tpu.train.engine import Engine as JaxEngine
    from herald_tpu.utils.profiler import comm_stats as jax_comm_stats
    jcfg = JaxConfig(model=model, batch_size=16, embedding_dim=8,
                     comm_mode="hybrid", a2a_capacity_factor=factor)
    jeng = JaxEngine(jcfg, mesh=Mesh(np.array(jax.devices()[:S]), ("dp",)),
                     table_rows=3000)
    cfg = HeraldConfig.from_json(jcfg.to_json())
    if S == 1:
        eng = Engine(cfg, table_rows=3000, device="cpu")
    else:
        # an engine's exchange over S ranks, without their process group
        one = Engine(cfg, table_rows=3000, device="cpu")
        eng = SimpleNamespace(width=one.width, exchange=make_exchange(
            3000, S, one.ids_per_worker, factor))
    assert eng.exchange.capacity == jeng.exchange.capacity
    assert comm_stats(eng) == jax_comm_stats(jeng)
    assert comm_stats(eng, dtype_bytes=2) == jax_comm_stats(jeng, 2)


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path / "logs")) as prof:
        (x @ x).relu_()
    names = {e.key for e in prof.key_averages()}
    assert "aten::mm" in names
    events = json.loads((tmp_path / "logs" / "trace.json").read_text())
    assert any(e.get("name") == "aten::mm"
               for e in events["traceEvents"])
