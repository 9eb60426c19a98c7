"""K3 `hot_onehot_push`: the f32 segment sum of grad rows by id.

Port of the Pallas kernel `herald_tpu/ops/pallas/kernels.py:259-282` to a
hand-written CUDA kernel (`csrc/hot_onehot_push.cu`). It keeps the JAX
contract, `(ids [N], grads [N, D] f32/bf16, num_rows) -> f32 [num_rows, D]`:
duplicates accumulate and ids outside [0, num_rows) are dropped. The
Pallas kernel's block-multiple rule on `num_rows` does not apply.

Bound on the card: bytes, each grad row read once and each output row
written once (77.6 MB, 0.023 ms at DeepFM's training shape of 26,624 x 513
f32 grads into ~11,100 rows). The kernel groups the positions itself, with
no library sort: integer atomics count each id and hand out slots, a
block-parallel pass gives each segment its range of slots and its work
(a warp for a segment of at most `WARP_ROWS` positions, a block for each
piece of at most `PIECE` positions of a longer one), and the positions
are placed. Every piece ranks its positions in ascending order (segments
of more than 512 are sorted first), its warps sum runs of `WARP_ROWS`
rows that are added in warp order, and a long segment's f32 partials are
added in piece order: the same inputs give the same bits on every launch.
The .cu header states the order of additions.

With `rows` (int32 [N]) position i sums grads[rows[i]] instead of
grads[i]: a multi-hot step hands K3 its pooled bags' gradient [B * bags,
D] and each position's bag row, and no [N, D] copy of each position's
gradient is written.

`hot_onehot_push` launches it for tensors on the card and uses the plain
version `hot_onehot_push_ref` only for tensors on the CPU. The wrapper
allocates the output and the scratch (`scratch_sizes`) and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from herald_tpu_torch.ops.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PIECE = 32          # most positions a block piece sums (kPiece in the .cu)
WARP_ROWS = 4       # segments up to this size take one warp (kWarpRows)
_INT32_MAX = 2**31 - 1


def hot_onehot_push_ref(ids: torch.Tensor, grads: torch.Tensor,
                        num_rows: int, rows: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain PyTorch version: each position's grad row (through `rows`
    when given), bounds mask, then `index_add_` of the f32 grads into
    zeros."""
    if rows is not None:
        grads = grads.index_select(0, rows.long())
    valid = (ids >= 0) & (ids < num_rows)
    out = torch.zeros((num_rows, grads.shape[1]), dtype=torch.float32,
                      device=grads.device)
    return out.index_add_(0, ids[valid], grads[valid].to(torch.float32))


def scratch_sizes(n: int, num_rows: int) -> Tuple[int, int, int]:
    """(zeroed int32 words, plain int32 words, f32 partial rows) of the
    kernel's scratch for n positions into num_rows rows. Bounds that hold
    for any ids: at most num_rows warp units (segments of at most
    WARP_ROWS positions); at most n // (WARP_ROWS + 1) block pieces
    (ceil(L / PIECE) <= L / (WARP_ROWS + 1) for L > WARP_ROWS), each with
    a partial row; at most n // (PIECE + 1) long segments."""
    max_pieces = n // (WARP_ROWS + 1)
    max_long = n // (PIECE + 1)
    zeroed = 4 + num_rows + max_long          # 2 cursors, counts, tickets
    # descriptors of 4 words (warp units, pieces, long segments), slots,
    # positions, segment offsets
    plain = 4 * (num_rows + max_pieces + max_long) + 2 * n + num_rows
    return zeroed, plain, max(1, max_pieces)


@functools.cache
def _launcher():
    fn = build.load("hot_onehot_push").herald_hot_onehot_push
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64] * 6
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def hot_onehot_push(ids: torch.Tensor, grads: torch.Tensor,
                    num_rows: int, rows: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """ids [N] int32/int64, grads [N, D] f32/bf16 (or [M, D] with `rows`,
    int32 [N], each in [0, M): not checked on the card) -> f32
    [num_rows, D]. On the card this launches the CUDA kernel or raises."""
    if ids.device.type == "cpu" and grads.device.type == "cpu":
        return hot_onehot_push_ref(ids, grads, num_rows, rows)
    if not grads.is_cuda or ids.device != grads.device:
        raise ValueError(f"hot_onehot_push: ids on {ids.device} and grads "
                         f"on {grads.device}; both must be on one card")
    if ids.dim() != 1 or grads.dim() != 2 or (
            rows is None and grads.shape[0] != ids.shape[0]):
        raise ValueError(f"hot_onehot_push: ids must be [N] and grads "
                         f"[N, D], got {tuple(ids.shape)} and "
                         f"{tuple(grads.shape)}")
    if rows is not None and (rows.dtype != torch.int32
                             or rows.shape != ids.shape
                             or rows.device != grads.device):
        raise ValueError(f"hot_onehot_push: rows must be int32 [N] on the "
                         f"grads' card, got {rows.dtype} "
                         f"{tuple(rows.shape)} on {rows.device}")
    if grads.dtype not in _DTYPE_CODES:
        raise ValueError(f"hot_onehot_push: grads dtype {grads.dtype} not "
                         f"in {list(_DTYPE_CODES)}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"hot_onehot_push: ids dtype {ids.dtype} is not "
                         f"int32 or int64")
    if num_rows < 0:
        raise ValueError(f"hot_onehot_push: num_rows {num_rows} < 0")
    N, D = ids.shape[0], grads.shape[1]
    if N >= _INT32_MAX or num_rows + N // PIECE >= _INT32_MAX:
        raise ValueError(f"hot_onehot_push: N = {N} and num_rows = "
                         f"{num_rows} exceed the kernel's int32 indices")
    out = torch.empty((num_rows, D), dtype=torch.float32, device=grads.device)
    if num_rows == 0 or D == 0:
        return out
    grads = grads.contiguous()
    ids = ids.contiguous()
    rows = rows.contiguous() if rows is not None else None
    zero_words, plain_words, partial_rows = scratch_sizes(N, num_rows)
    zeroed = torch.zeros(zero_words, dtype=torch.int32, device=grads.device)
    scratch = torch.empty(plain_words, dtype=torch.int32, device=grads.device)
    partials = torch.empty((partial_rows, D), dtype=torch.float32,
                           device=grads.device)
    build.launch("hot_onehot_push", _launcher(), grads.device,
                 ids.data_ptr(), grads.data_ptr(),
                 rows.data_ptr() if rows is not None else None,
                 out.data_ptr(),
                 zeroed.data_ptr(), scratch.data_ptr(), partials.data_ptr(),
                 N, num_rows, D, zero_words, plain_words, partial_rows,
                 _DTYPE_CODES[grads.dtype], int(ids.dtype == torch.int64))
    hot_onehot_push.launches += 1
    return out


hot_onehot_push.launches = 0
