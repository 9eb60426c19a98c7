#!/usr/bin/env python
"""Herald trainer (the counterpart of `examples/run_scheduled.py`, the
reference's `examples/ctr/run_laia.py`): the lookahead planner assigns
samples by cache affinity and plans flush and refresh; the hot-row cache
keeps embedding reads local.

    python herald_tpu_torch/examples/run_scheduled.py --model wdl_criteo \\
        --nepoch 1 --batch-size 256 --embedding-size 128 \\
        --cache-limit-ratio 0.1 [--device cpu]
    python -m torch.distributed.run --standalone --nproc-per-node S \\
        herald_tpu_torch/examples/run_scheduled.py --comm hybrid [...]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from herald_tpu_torch.launch.cli import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] + ["--scheduled"]))
