"""The yardstick's arithmetic: the card's peaks, the kernels' names as the
profiler shows them, and the bytes each kernel needs for its inputs.

A kernel's bytes follow one rule: each input byte it must read is counted
once and each output byte once, whatever the kernel reads again. A row
that several positions read counts once; an id outside its table (a
padding sentinel) reads nothing but its output row is still written.
Device time comes from the trace, so a share is the least time the bytes
could take at the peak bandwidth over the time the kernel took. A step's
rows take a few MB at wdl and tens of MB at dfm, and the card's L2 holds
50 MB, so data a kernel finds there can bring a share near 100%.
"""

from __future__ import annotations

import re

import numpy as np

# NVIDIA H100 SXM, the data sheet's dense rates at 700 W
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12          # f32 outside the tensor cores (TF32 off)

# the port's hand-written kernels by the names of their CUDA kernels
KERNELS = {
    "k1": (r"\bgather_rows\b",),
    "k2": (r"\bscatter_rows\b",),
    "k3": (r"\bcount_ids\b", r"\balloc_segments\b", r"\bplace_positions\b",
           r"\bsort_big\b", r"\bsum_segments\b"),
    "k5": (r"\bfm_forward\b", r"\bfm_backward\b"),
}
_PATTERNS = {k: [re.compile(p) for p in v] for k, v in KERNELS.items()}


def kernel_of(name: str):
    """Which of KERNELS a device operation's name belongs to, or None."""
    for k, pats in _PATTERNS.items():
        if any(p.search(name) for p in pats):
            return k
    return None


def distinct(ids, lo: int, hi: int) -> int:
    """Distinct ids in [lo, hi)."""
    a = np.asarray(ids).reshape(-1)
    return int(np.unique(a[(a >= lo) & (a < hi)]).size)


def k1_bytes(n: int, rows: int, width: int, src: int, out: int,
             idx: int) -> int:
    """K1 `embedding_gather` of n ids, `rows` of them distinct and inside
    the table: each such row read once (`src` bytes an element), n rows
    written (`out` bytes an element), the ids read once."""
    return rows * width * src + n * width * out + n * idx


def k2_bytes(n: int, rows: int, width: int, table: int, idx: int) -> int:
    """K2 `rows_scatter_add` with lr over n id slots, `rows` of them real:
    the ids, the real rows' f32 gradients and lr read once, each real
    table row read and written once."""
    return n * idx + rows * width * 4 + 2 * rows * width * table + 4


def k3_bytes(n: int, rows: int, width: int, idx: int) -> int:
    """K3 `hot_onehot_push` of n positions into `rows` distinct segments:
    the ids and the f32 gradients read once, each segment's f32 sum
    written once (the untouched output rows are the memset's, which is
    neither counted nor timed)."""
    return n * idx + n * width * 4 + rows * width * 4


def k5_bytes(batch: int, fields: int, dim: int, train: bool) -> int:
    """K5's forward (and with `train` its backward) on f32 [B, F, D]:
    forward reads the embeddings and writes the term (and, for the
    backward, the f32 sums s); backward reads the embeddings, s and the
    term's gradient and writes the embeddings' gradient."""
    e = batch * fields * dim * 4
    if not train:
        return e + batch * 4
    fwd = e + batch * 4 + batch * dim * 4
    bwd = 2 * e + batch * dim * 4 + batch * 4
    return fwd + bwd


def share(nbytes: float, seconds: float):
    """Percent of the bandwidth roofline, or None with nothing timed."""
    if not seconds or seconds <= 0 or not nbytes:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
