"""Fixtures of the benchmark's tests. Whether a card is present is
decided inside the `card` fixture, never while a module is imported."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# a table small enough for the CPU, every width as the cells have it
FULL_WIDTH = {"config": {"table_rows": 100_000},
              "mix": {"samples_log2": 13, "epochs": 200,
                      "warm_quiet_chunks": 1, "max_warm_chunks": 400,
                      "trace_units": 1, "pool_requests": 4,
                      "checked_requests": 2, "warm_quiet_requests": 1}}
# smaller still, for runs of the whole harness
TINY = {"config": {"table_rows": 60_000, "embedding_dim": 16,
                   "batch_size": 32},
        "mix": {"samples_log2": 13, "epochs": 200, "warm_quiet_chunks": 2,
                "trace_units": 2, "rows_per_request": 64,
                "pool_requests": 16, "checked_requests": 4,
                "warm_quiet_requests": 2}}


@pytest.fixture
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.cuda.get_device_name(0)


# the serve driver's cell, which BENCHMARK.json does not hold (it waits
# for a configuration backed by a published run): DeepFM over Criteo on
# an f32 table, scored 1024 rows a request
SERVE_CONFIG = {
    "name": "dfm_criteo", "model": "dfm_criteo", "reference": "dfm",
    "batch_size": 1024, "embedding_dim": 512, "table_rows": 33762577,
    "num_sparse": 26, "num_dense": 13, "table_dtype": "float32",
    "tower_dtype": "float32", "tf32": False,
    "tower": {"widths": [256, 256, 1], "init_std": 0.01},
    "optimizer": "sgd", "learning_rate": 0.01, "cache_limit_ratio": 0.1}
SERVE_CELL = "dfm_criteo.serve_b1024"


@pytest.fixture
def serve_bench(bench, tmp_path):
    """(BENCHMARK.json with the serve cell added, a copy of portbench/
    with its configuration and limits beside the rest)."""
    base = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (base / "configs" / "dfm_criteo.json").write_text(
        json.dumps(SERVE_CONFIG))
    (base / "limits" / f"{SERVE_CELL}.json").write_text(
        json.dumps({"score_gap": 2e-6}))
    bench = json.loads(json.dumps(bench))
    bench["configs"].append({"name": "dfm_criteo", "source": "x",
                             "file": "portbench/configs/dfm_criteo.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": SERVE_CELL, "config": "dfm_criteo",
                               "traffic": "serve_b1024", "chips": 1,
                               "why": "x"})
    for name, unit, better in (("score_ms_p95", "ms", "lower"),
                               ("scored_examples_per_s", "examples/s",
                                "higher")):
        bench["end_to_end"].append({"name": name, "unit": unit,
                                    "better": better, "bound": 0.25,
                                    "source": "host_clock",
                                    "workloads": [SERVE_CELL]})
    for name, src in (("step_mfu.serve", "host_clock"),
                      ("k1_gather_roofline.serve", "device_trace"),
                      ("device_idle_share.serve", "device_trace"),
                      ("predict_device_ms", "device_trace")):
        bench["per_layer"].append({"name": name, "unit": "%",
                                   "better": "higher", "source": src,
                                   "layer": "Eval step",
                                   "moves": "score_ms_p95",
                                   "workloads": [SERVE_CELL]})
    return bench, base
