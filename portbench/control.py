"""The readings of the check's controls and faults, at a cell's own size:
the reference put in the program's place, computed in a lower precision
or with a fault planted, against the reference itself. The benchmark's
runs do not run this; the limits in `limits/<workload>.json` are set
between what sound runs of the program read and what these read.

    python3 portbench/control.py --workload <name> --seeds 1,2,3

Controls: "tf32" (every product's operands rounded to TF32, exact on any
device, `reference/precision.py`), "tf32_card" (the card's own TF32
products, with the library's TF32 switched on), "bfloat16" (a bf16
tower). Training cells add the fault "half_batch" (half of each batch
left out, the mean taken over the rest). A step that leaves its state
unchanged reads 1 in change_gap by definition and needs no run. Prints
one JSON line a seed and control.

With `--program-faults half_batch,dropped_pull,...` it runs the cell
instead, in this process, with each fault of `faults.py` planted in the
program, and prints every number the check compares (the churned steps'
too):

    python3 portbench/control.py --workload wdl_criteo.sched_churn \
        --seeds 1,2,3 --program-faults half_batch,dropped_pull --seconds 2
"""

from __future__ import annotations

import argparse
import gc
import io
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import checks, faults, harness, judge  # noqa: E402


def training_controls(run, names):
    cfg, mix = run.cfg, run.mix
    B, k = cfg["batch_size"], mix["check_steps"]
    n = 1 << mix["samples_log2"]
    _, ids, _ = checks.stream(run, n)
    union = np.unique(ids[:k * B].cpu().numpy().reshape(-1))
    del ids
    base = checks.reference_readings(run, union, n, k)
    out = {}
    for name in names:
        kw = {"half_batch": True} if name == "half_batch" else \
            {"matmul": "float32" if name == "tf32_card" else name}
        if name == "tf32_card":
            kw["card_tf32"] = True
        _, losses, c1, c3 = checks.reference_readings(run, union, n, k,
                                                           **kw)
        out[name] = judge.training(losses, base[1], base[0], c1, c3,
                                   base[2], base[3], cfg["learning_rate"])
    return out


def serving_controls(run, names):
    R, pool = run.mix["rows_per_request"], run.mix["pool_requests"]
    k = min(run.mix["checked_requests"], pool)
    dense, ids, _ = checks.stream(run, k * R)
    d = dense.cpu().numpy().reshape(k, R, -1)
    s = ids.cpu().numpy().reshape(k, R, -1)
    base = checks.reference_scores(run, d, s).cpu()
    out = {}
    for name in names:
        got = checks.reference_scores(
            run, d, s, matmul="float32" if name == "tf32_card" else name,
            card_tf32=name == "tf32_card")
        out[name] = judge.scoring(got.cpu(), base)
    return out


def program_faults(args, bench, base, device, overrides, out):
    rows = []
    for fault in args.program_faults.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            run = harness.Run(bench, args.workload, seed, args.seconds,
                              False, device, overrides, base)
            err = io.StringIO()
            with faults.plant(fault):
                res = harness.execute(run, time.perf_counter(),
                                      out=io.StringIO(), err=err)
            del run
            if device != "cpu":
                # the next run's set-up finds the card as a run's does
                gc.collect()
                torch.cuda.empty_cache()
            numbers = {k: v["value"] for k, v in res["checks"].items()}
            for line in err.getvalue().splitlines():
                if line.startswith("reading "):
                    k, v = line[len("reading "):].split(": ")
                    numbers[k] = float(v)
            row = {"workload": args.workload, "seed": seed,
                   "program_fault": fault, "correct": res["correct"],
                   **numbers}
            rows.append(row)
            print(json.dumps(row), file=out, flush=True)
    return rows


def main(argv=None, device="cuda", overrides=None, out=sys.stdout,
         bench=None, base=harness.HERE):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="tf32,tf32_card,bfloat16,"
                                          "half_batch")
    ap.add_argument("--program-faults", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if args.program_faults:
        return program_faults(args, bench, base, device, overrides, out)
    names = args.controls.split(",")
    if device == "cpu":
        names = [n for n in names if n != "tf32_card"]
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(bench, args.workload, seed, 0, False, device,
                          overrides, base)
        if run.mix["driver"] == "serve":
            got = serving_controls(run, [n for n in names
                                         if n != "half_batch"])
        else:
            got = training_controls(run, names)
        for name, numbers in got.items():
            row = {"workload": args.workload, "seed": seed,
                   "control": name, **numbers}
            rows.append(row)
            print(json.dumps(row), file=out, flush=True)
        if device != "cpu":
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
