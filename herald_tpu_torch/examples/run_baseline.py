#!/usr/bin/env python
"""Baseline trainer (the counterpart of `examples/run_baseline.py`, the
reference's `examples/ctr/run_hetu.py`): the plain engine, every step
reads its rows from the table (or from their owner ranks), no cache, no
lookahead scheduling.

    python herald_tpu_torch/examples/run_baseline.py --model wdl_criteo \\
        --nepoch 1 --batch-size 256 --embedding-size 128 [--device cpu]
    python -m torch.distributed.run --standalone --nproc-per-node S \\
        herald_tpu_torch/examples/run_baseline.py --comm hybrid [...]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from herald_tpu_torch.launch.cli import main

if __name__ == "__main__":
    sys.exit(main())
