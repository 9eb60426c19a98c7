"""The multi-hot cell (`dlrm_dcnv2_criteo1tb.plain_multihot`, driver
`plain_bags`) on the CPU at a tiny size, with the kernels' plain
versions: its stream, its configuration's published widths, its
reference's operation count, its controls and its reader."""

import io
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from conftest import ROOT
from test_portbench_drivers import run_cell

from portbench import control_bags, harness

CELL = "dlrm_dcnv2_criteo1tb.plain_multihot"
PUBLISHED_ROWS = [40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63,
                  40000000, 3067956, 405282, 10, 2209, 11938, 155, 4, 976,
                  14, 40000000, 40000000, 40000000, 590152, 12973, 108, 36]
BAGS = [3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100,
        27, 10, 3, 1, 1]
# every table cut to a 5,000th (at least a row), embedding 16, batch 32
ROWS = [max(1, min(r, 24_000_000) // 5000) for r in PUBLISHED_ROWS]
TINY = {"config": {"table_rows": sum(ROWS), "rows_per_table": ROWS,
                   "batch_size": 32, "embedding_dim": 16,
                   "tower": {"bottom": [512, 256, 16], "cross_layers": 3,
                             "cross_rank": 512,
                             "top": [1024, 1024, 512, 256, 1]}},
        "mix": {"samples_log2": 9, "warm_quiet_chunks": 2, "trace_units": 2}}


def cfg_file():
    return json.loads((ROOT / "portbench" / "configs" /
                       "dlrm_dcnv2_criteo1tb.json").read_text())


def test_configuration_holds_the_published_widths():
    cfg = cfg_file()
    assert cfg["multi_hot_sizes"] == BAGS and cfg["num_sparse"] == 214
    assert cfg["published"]["rows_per_table"] == PUBLISHED_ROWS
    assert cfg["rows_per_table"] == [min(r, 24_000_000)
                                     for r in PUBLISHED_ROWS]
    assert cfg["table_rows"] == sum(cfg["rows_per_table"]) == 124_184_588
    assert (cfg["embedding_dim"], cfg["num_dense"], cfg["batch_size"]) == \
        (128, 13, 8192)
    assert cfg["tower"] == {"bottom": [512, 256, 128], "cross_layers": 3,
                            "cross_rank": 512,
                            "top": [1024, 1024, 512, 256, 1]}
    assert cfg["reduced"] == ["table_rows"] and cfg["tf32"] is False
    assert set(cfg["why_reduced"]) == {"table_rows"} and cfg["assumed"]


def test_reference_counts_the_step_by_its_products(bench):
    run = harness.Run(bench, CELL, 1, 1, False, device="cpu")
    ref = run.reference()
    # 16,030,464 multiply-adds a sample forward; backward twice that but
    # the dense features' input gradient (13 x 512)
    fwd = 2.0 * 16_030_464
    assert ref.flops(run.cfg, 1, False) == fwd
    assert ref.flops(run.cfg, 8192, True) == 8192 * (3 * fwd - 2 * 13 * 512)
    shapes = ref.shapes(run.cfg)
    assert shapes["cross_V1"] == (3456, 512) and shapes["top_W1"] == \
        (3456, 1024)


def test_stream_keeps_each_bag_in_its_table():
    drv = harness.load_module(ROOT / "portbench" / "drivers" /
                              "plain_bags.py", "bags_stream")
    cfg = {**cfg_file(), **TINY["config"]}
    dense, ids, labels = drv.multihot_stream(cfg, 1.2, 64, 2**33 + 5, "cpu")
    assert ids.shape == (64, 214) and ids.dtype == torch.int32
    assert dense.shape == (64, 13) and labels.shape == (64, 1)
    lo = drv.table_offsets(cfg)
    p = 0
    for t, bag in enumerate(BAGS):
        part = ids[:, p:p + bag]
        assert int(part.min()) >= lo[t]
        assert int(part.max()) < lo[t] + ROWS[t]
        p += bag
    again = drv.multihot_stream(cfg, 1.2, 64, 2**33 + 5, "cpu")
    assert all(torch.equal(a, b) for a, b in zip((dense, ids, labels),
                                                  again))
    with pytest.raises(ValueError, match="rows_per_table"):
        drv.table_offsets({**cfg, "table_rows": sum(ROWS) + 1})


def test_cell_runs_and_is_correct(bench):
    res, err = run_cell(bench, CELL, 2**31 + 11, overrides=TINY)
    assert res["correct"], err
    assert set(res["metrics"]) == {"train_examples_per_s", "setup_s"}
    assert set(res["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                  "rows_gap"}


def test_traced_run_reads_host_metrics(bench):
    res, err = run_cell(bench, CELL, 7, trace=True, overrides=TINY)
    assert res["correct"], err
    assert {"dispatch_host_ms_per_step", "step_mfu.train"} <= \
        set(res["metrics"])
    # nothing ran on a device here: no roofline is read as 0
    assert not any("roofline" in k for k in res["metrics"])


def test_controls_run_at_a_tiny_size(bench):
    out = io.StringIO()
    rows = control_bags.main(["--workload", CELL, "--seeds", "3"],
                             device="cpu", overrides=TINY, out=out,
                             bench=bench)
    got = {r["control"]: r for r in rows}
    assert set(got) == {"tf32", "bfloat16", "half_batch"}
    assert got["half_batch"]["loss_gap"] > 1e-4
    assert got["bfloat16"]["grad_gap"] > got["tf32"]["grad_gap"] > 0


def test_bag_reader_reads_its_own_kernel():
    reader = harness.load_module(ROOT / "portbench" / "metrics" /
                                 "k1_bag_roofline.py", "k1_bag_reader")
    by_name = {"void (anonymous namespace)::gather_pool_rows<float, 32, "
               "int, true>(float const*)": 1e-3,
               "void (anonymous namespace)::gather_rows<float, float>()": 5.0}
    r = SimpleNamespace(trace=SimpleNamespace(by_name=by_name),
                        work={"k1_bag": 3.35e9 * 0.5})
    assert reader.read(r) == pytest.approx(50.0)
    assert reader.read(SimpleNamespace(trace=None, work={})) is None
    r.work = {}
    assert reader.read(r) is None


def test_entries_list_the_new_cell_where_it_reads(bench):
    per = {m["name"]: m for m in bench["per_layer"]}
    for name in ("k1_bag_roofline.train", "step_mfu.train",
                 "k3_push_roofline.train", "k2_scatter_roofline.train",
                 "device_idle_share.train", "peak_device_gb.train",
                 "span_dispatch_ms_per_step",
                 "idle_outside_spans_ms_per_step",
                 "dispatch_host_ms_per_step"):
        assert CELL in per[name]["workloads"], name
    assert CELL not in per["k1_gather_roofline.train"]["workloads"]
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells[CELL]["chips"] == 1
    assert np.all([len(w["why"]) <= 200 for w in bench["workloads"]])
