"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source `csrc/<name>.cu` exposes a plain C interface and compiles on
its own into `herald_tpu_torch/_build/lib<name>.<hash>.so` (the hash is of
the source, the headers `csrc/*.cuh` and the flags, so an edited source
rebuilds). Nothing is built at import: the first launch builds what it
needs, and `build_all` builds every kernel at once, one nvcc process per
source, all started together. The build reads only the sources in this
package. `launch` calls a built entry point on PyTorch's current stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
SOURCES = ("embedding_gather", "fm_second_order", "hot_onehot_gather",
           "hot_onehot_push", "rows_scatter_add", "unique_fill")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels build on the machine with "
                       "the card")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}.{digest[:12]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source not yet built, in parallel. Returns
    {name: nvcc's output} (ptxas register and spill counts) for the ones
    it compiled; raises with nvcc's output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs: List = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)    # atomic: concurrent builders race safely
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    if name not in _LIBS:
        build_all([name])
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]


def launch(name: str, fn, device: torch.device, *args) -> None:
    """fn(*args, stream): a kernel's C entry point on PyTorch's current
    stream of `device`, a card; raises with the CUDA error if the launch
    failed. A launch goes to the calling thread's current device, so the
    card is made current for the call, but only when it is not already:
    a `torch.cuda.device` context on every call cost the host more than
    the ctypes call (`chip_smoke.py`'s `wrapper_host_us`). The raw stream
    handle is the one PyTorch's own Triton launcher reads."""
    if device.index == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
