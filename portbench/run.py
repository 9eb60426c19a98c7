"""Runs one cell of the benchmark of `herald_tpu_torch` on the cards of
this machine and prints its result as one JSON line, the last of
standard output:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, traffic mix, metrics and the limits of its
check are read from BENCHMARK.json and the files under portbench/ by
name (`portbench/harness.py`). Without a card, or with fewer cards than
the cell asks for, it prints no result and exits with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    # the program's kernel and graph caches stay inside the checkout, at
    # fixed paths, so that only a checkout's first run builds
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "portbench_cache" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "portbench_cache" / "torch_extensions"))
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import harness

    run = harness.Run(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < run.cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {run.cell['chips']} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 3
    try:
        import herald_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program under test is missing: {e}", file=sys.stderr)
        return 4
    harness.execute(run, T_START)
    return 0


if __name__ == "__main__":
    sys.exit(main())
