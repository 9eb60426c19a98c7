#!/usr/bin/env python
"""FAE-baseline trainer (the counterpart of `examples/run_fae.py`, the
reference's `examples/ctr/run_laia_fae.py`): hot/cold split embeddings,
the most frequent ids in a replicated block whose gradient is summed over
the ranks, the cold ids through the row-sharded exchange.

    python herald_tpu_torch/examples/run_fae.py --model fae_wdl_criteo \\
        --nepoch 1 --batch-size 256 --embedding-size 128 --hot-rate 0.01 \\
        [--device cpu]
    python -m torch.distributed.run --standalone --nproc-per-node S \\
        herald_tpu_torch/examples/run_fae.py --comm hybrid [...]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from herald_tpu_torch.launch.cli import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] + ["--fae"]))
