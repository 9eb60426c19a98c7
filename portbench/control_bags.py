"""The readings of the check's controls and faults at a multi-hot cell's
own size (`drivers/plain_bags.py`), as `control.py` gives them for the
one-hot cells: the reference put in the program's place, computed in a
lower precision or with half of each batch left out, against the
reference itself. The limits in `limits/<workload>.json` are set between
what sound runs of the program read and what these read.

    python3 portbench/control_bags.py \
        --workload dlrm_dcnv2_criteo1tb.plain_multihot --seeds 1,2,3

Controls: "tf32", "tf32_card", "bfloat16" and the fault "half_batch", as
`control.py` defines them. Prints one JSON line a seed and control. The
program's own faults run through `control.py --program-faults`.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness, judge  # noqa: E402


def controls(run, names):
    drv = run.driver()
    cfg, mix = run.cfg, run.mix
    B, k = cfg["batch_size"], mix["check_steps"]
    n = 1 << mix["samples_log2"]
    _, ids, _ = drv.multihot_stream(cfg, mix["zipf_a"], n, run.seed,
                                    run.device)
    union = np.unique(ids[:k * B].cpu().numpy().reshape(-1))
    del ids
    base = drv.reference_readings(run, union, n, k)
    out = {}
    for name in names:
        kw = {"half_batch": True} if name == "half_batch" else \
            {"matmul": "float32" if name == "tf32_card" else name}
        if name == "tf32_card":
            kw["card_tf32"] = True
        _, losses, c1, c3 = drv.reference_readings(run, union, n, k, **kw)
        out[name] = judge.training(losses, base[1], base[0], c1, c3,
                                   base[2], base[3], cfg["learning_rate"])
    return out


def main(argv=None, device="cuda", overrides=None, out=sys.stdout,
         bench=None, base=harness.HERE):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="tf32,tf32_card,bfloat16,"
                                          "half_batch")
    args = ap.parse_args(argv)
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = args.controls.split(",")
    if device == "cpu":
        names = [n for n in names if n != "tf32_card"]
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(bench, args.workload, seed, 0, False, device,
                          overrides, base)
        for name, numbers in controls(run, names).items():
            row = {"workload": args.workload, "seed": seed,
                   "control": name, **numbers}
            rows.append(row)
            print(json.dumps(row), file=out, flush=True)
        if device != "cpu":
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
