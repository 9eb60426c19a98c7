"""K1 `embedding_gather`: out[i] = table[ids[i]], a zero row for ids
outside [0, R), in the table's dtype or widened from bf16 to f32.

Port of the Pallas kernel `herald_tpu/ops/pallas/kernels.py:76-110` to a
hand-written CUDA kernel (`csrc/embedding_gather.cu`). `embedding_gather`
launches it for tensors on the card and uses the plain version
`embedding_gather_ref` only for tensors on the CPU. The two are bit-exact:
the kernel copies bytes, and widens bf16 to f32 by shifting its 16 bits
up, which is exact.

The engine reads its activations by position with f32 output: one launch
over the batch's `B*F` ids gives the tower's f32 `[B, F, W]` input, with
no dedup sort, no `[inv]` expansion and no widening copy. A row that
several positions read comes from the card's L2 after the first.

`gather_pool_rows` is K1's pooled form for multi-hot models (no Pallas
counterpart): ids [B, P] whose positions form contiguous bags, `offsets`
[bags + 1] -> the f32 sum of each bag's rows [B, bags, W] in one launch
(the kernel `gather_pool_rows` in the same source), with no [B, P, W]
intermediate. Each bag is summed in position order from its first row,
so a bag of one gives K1's bits, and `gather_pool_rows_ref` is its plain
version, bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from herald_tpu_torch.ops.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def out_dtype_of(table: torch.Tensor,
                 out_dtype: Optional[torch.dtype]) -> torch.dtype:
    """The output dtype K1 writes: the table's own, or float32 from a bf16
    table. Raises on any other."""
    if out_dtype is None or out_dtype == table.dtype:
        return table.dtype
    if table.dtype == torch.bfloat16 and out_dtype == torch.float32:
        return out_dtype
    raise ValueError(f"embedding_gather: out_dtype {out_dtype} from a "
                     f"{table.dtype} table; it writes the table's dtype or, "
                     f"from bfloat16, float32")


def embedding_gather_ref(table: torch.Tensor, ids: torch.Tensor,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """Plain PyTorch version: bounds mask, `index_select` on the clamped
    ids, zero the out-of-range rows, then `.to(out_dtype)`."""
    dtype = out_dtype_of(table, out_dtype)
    valid = (ids >= 0) & (ids < table.shape[0])
    out = table.index_select(0, torch.where(valid, ids, 0))
    return out.masked_fill_(~valid.unsqueeze(1), 0).to(dtype)


@functools.cache
def _launcher():
    fn = build.load("embedding_gather").herald_embedding_gather
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_gather_args(name: str, table: torch.Tensor,
                      ids: torch.Tensor) -> None:
    """Raise unless table [R, D] f32/bf16 and ids [N] int32/int64 lie,
    contiguous, on one card: what the row-gather kernels (K1, K4) take."""
    if not table.is_cuda or ids.device != table.device:
        raise ValueError(f"{name}: table on {table.device} and ids on "
                         f"{ids.device}; both must be on one card")
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"{name}: table must be [R, D] and ids [N], got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    if table.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: table dtype {table.dtype} not in "
                         f"{list(DTYPE_CODES)}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: ids dtype {ids.dtype} is not int32 or "
                         f"int64")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError(f"{name}: table and ids must be contiguous")


def embedding_gather(table: torch.Tensor, ids: torch.Tensor,
                     out_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """table [R, D] f32/bf16, ids [N] int32/int64 -> [N, D] in `out_dtype`
    (default the table's; float32 from a bf16 table widens). On the card
    this launches the CUDA kernel or raises."""
    if table.device.type == "cpu" and ids.device.type == "cpu":
        return embedding_gather_ref(table, ids, out_dtype)
    dtype = out_dtype_of(table, out_dtype)
    check_gather_args("embedding_gather", table, ids)
    R, D = table.shape
    N = ids.shape[0]
    out = torch.empty((N, D), dtype=dtype, device=table.device)
    if N == 0 or D == 0:
        return out
    build.launch("embedding_gather", _launcher(), table.device,
                 table.data_ptr(), ids.data_ptr(), out.data_ptr(), R, D, N,
                 DTYPE_CODES[table.dtype], DTYPE_CODES[dtype],
                 int(ids.dtype == torch.int64))
    embedding_gather.launches += 1
    return out


embedding_gather.launches = 0


def check_offsets(offsets: torch.Tensor, positions: int) -> None:
    """Raise unless `offsets` is a 1-d int32 tensor of at least 2 entries
    that starts at 0, never falls and ends at `positions` (read on the
    CPU only: the card's tensor is taken as the caller built it)."""
    if offsets.dtype != torch.int32 or offsets.dim() != 1 \
            or offsets.numel() < 2:
        raise ValueError(f"gather_pool_rows: offsets must be int32 [bags + "
                         f"1], got {offsets.dtype} {tuple(offsets.shape)}")
    if offsets.device.type == "cpu":
        o = offsets.tolist()
        if o[0] != 0 or o[-1] != positions or any(
                b < a for a, b in zip(o, o[1:])):
            raise ValueError(f"gather_pool_rows: offsets {o} do not cut "
                             f"{positions} positions into bags")


def pool_bags(rows: torch.Tensor, offsets) -> torch.Tensor:
    """rows [B, P, W] -> [B, bags, W] in their dtype: bag k (positions
    `offsets[k]` to `offsets[k + 1]`) summed in position order from its
    first row; an empty bag is zeros. Differentiable."""
    o = list(offsets)
    out = rows.new_zeros((rows.shape[0], len(o) - 1, rows.shape[2]))
    for k, (a, b) in enumerate(zip(o, o[1:])):
        if b > a:
            acc = rows[:, a].clone()
            for j in range(a + 1, b):
                acc += rows[:, j]
            out[:, k] = acc
    return out


def gather_pool_rows_ref(table: torch.Tensor, ids: torch.Tensor,
                         offsets: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: K1's rows by position in f32 (zero rows for
    ids outside the table), pooled by `pool_bags`."""
    check_offsets(offsets, ids.shape[1])
    B, P = ids.shape
    rows = embedding_gather_ref(table, ids.reshape(-1), torch.float32
                                ).view(B, P, table.shape[1])
    return pool_bags(rows, offsets.tolist())


@functools.cache
def _pool_launcher():
    fn = build.load("embedding_gather").herald_gather_pool_rows
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_pool_rows(table: torch.Tensor, ids: torch.Tensor,
                     offsets: torch.Tensor) -> torch.Tensor:
    """table [R, W] f32/bf16, ids [B, P] int32/int64, offsets [bags + 1]
    int32 (0, ..., P) -> f32 [B, bags, W]: each bag's rows summed, an id
    outside [0, R) adding zeros. On the card this launches the CUDA kernel
    or raises; `offsets` is then not read back (it must be the card's)."""
    if table.device.type == "cpu" and ids.device.type == "cpu":
        return gather_pool_rows_ref(table, ids, offsets)
    if ids.dim() != 2 or offsets.device != table.device:
        raise ValueError(f"gather_pool_rows: ids must be [B, P] and offsets "
                         f"on the table's card, got {tuple(ids.shape)} and "
                         f"offsets on {offsets.device}")
    ids = ids.contiguous()
    check_gather_args("gather_pool_rows", table, ids.view(-1))
    check_offsets(offsets, ids.shape[1])
    B, P = ids.shape
    bags = offsets.numel() - 1
    R, W = table.shape
    out = torch.empty((B, bags, W), dtype=torch.float32, device=table.device)
    if B == 0 or W == 0:
        return out
    build.launch("gather_pool_rows", _pool_launcher(), table.device,
                 table.data_ptr(), ids.data_ptr(), offsets.data_ptr(),
                 out.data_ptr(), R, W, B, P, bags, DTYPE_CODES[table.dtype],
                 int(ids.dtype == torch.int64))
    gather_pool_rows.launches += 1
    return out


gather_pool_rows.launches = 0
