"""herald_tpu_torch — the PyTorch and CUDA port of herald_tpu, for NVIDIA
Hopper (H100).

It keeps the JAX package's layout and names, so each module's counterpart
is found by path (`herald_tpu_torch/train/engine.py` ports
`herald_tpu/train/engine.py`). Every Pallas kernel of the JAX package on a
ported path becomes a hand-written CUDA kernel under `ops/kernels/`. The
port imports torch, numpy and the standard library only: nothing of JAX
and nothing of `herald_tpu`. Ported so far: serving
(`python -m herald_tpu_torch.serve`) and plain local training
(`python -m herald_tpu_torch.launch`, `Engine.train_step` /
`train_epoch`); ROADMAP.md lists what follows.
"""

from herald_tpu_torch.config import HeraldConfig
from herald_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from herald_tpu_torch.train.engine import Engine, TrainState

__version__ = "0.2.0"
