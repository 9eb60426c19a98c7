"""Row-sharded embedding exchange (port of `herald_tpu/parallel/exchange.py`).

The table's rows are owned strided over S ranks: logical row r lives on
rank r % S at local slot r // S, and the physical array is the ranks'
blocks of `rows_per_shard` rows one after the other
(`ExchangeSpec.phys_index`). A step's unique ids are bucketed by owner and
sent to it by an all-to-all (`route_ids`); each owner reads the rows asked
of it and sends them back (`owner_rows`, `gather_rows`); the gradients
travel the reverse all-to-all and are summed on the owner per local row
(`scatter_grads`).

Every shape is fixed: each (source, destination) pair has `capacity` id
slots a step, and the ids beyond it are dropped and counted (`overflow`).
Each function runs on one rank, as JAX's run inside `shard_map`; `comm`
(`parallel/comm.py`) stands where JAX names its mesh axis, and may be None
when S = 1.

On the card the rows move through the port's kernels: the owner's read of
the received ids is one K1 launch on its block in the table's dtype (an
empty slot, -1, reads the `rows_per_shard` sentinel: a zero row); the
sender fills its send buffer of gradients with one K1 read over the slots
(`Route.src`; an empty slot reads a zero row, as JAX's zero-filled buffer
holds); the owner sums the received gradients per local row with K3
(`ops.embedding.segment_sum_grads`), the empty slots sent past the last
segment so that K3 drops them (JAX adds their zeros into the masked
sentinel row).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from herald_tpu_torch.ops.embedding import segment_sum_grads, unique_static
from herald_tpu_torch.ops.kernels import embedding_gather


@dataclasses.dataclass(frozen=True)
class ExchangeSpec:
    """The exchange's static sizes (JAX's spec without its mesh axis name:
    the port passes the process group instead)."""
    num_shards: int
    rows_per_shard: int  # padded so num_shards * rows_per_shard >= num_rows
    num_rows: int        # valid (un-padded) table height
    capacity: int        # id slots per (source, destination) pair a step

    @property
    def padded_rows(self) -> int:
        return self.num_shards * self.rows_per_shard

    # ---- strided ownership maps (logical row id <-> physical position) ---
    def owner_of(self, ids):
        """Rank owning logical row id (numpy or torch)."""
        return ids % self.num_shards

    def local_of(self, ids):
        """Owner-local slot of logical row id."""
        return ids // self.num_shards

    def phys_index(self, ids):
        """Position of logical row id in the physical array."""
        return (ids % self.num_shards) * self.rows_per_shard \
            + ids // self.num_shards

    def logical_index(self, phys):
        """Inverse of phys_index (may exceed num_rows on padding slots)."""
        return (phys % self.rows_per_shard) * self.num_shards \
            + phys // self.rows_per_shard

    def to_physical(self, table_logical: np.ndarray) -> np.ndarray:
        """The padded physical array of a logical [num_rows, ...] host
        array (padding slots zero)."""
        logical = self.logical_index(np.arange(self.padded_rows))
        ok = logical < len(table_logical)
        out = np.zeros((self.padded_rows,) + table_logical.shape[1:],
                       table_logical.dtype)
        out[ok] = table_logical[logical[ok]]
        return out

    def to_logical(self, table_physical: np.ndarray) -> np.ndarray:
        """The logical [num_rows, ...] view of the physical array."""
        phys = self.phys_index(np.arange(self.num_rows))
        return np.asarray(table_physical)[phys]

    def block_of(self, table_logical: torch.Tensor, rank: int
                 ) -> torch.Tensor:
        """Rank `rank`'s block [rows_per_shard, ...] of a logical table
        (at least num_rows rows; those past num_rows are ignored), on the
        table's device, in one strided copy: local slot l holds logical
        row l * S + rank, and the padding slots are zero."""
        n = len(range(rank, self.num_rows, self.num_shards))
        out = table_logical.new_zeros((self.rows_per_shard,)
                                      + tuple(table_logical.shape[1:]))
        out[:n] = table_logical[rank:self.num_rows:self.num_shards]
        return out


def make_exchange(num_rows: int, num_shards: int, ids_per_step: int,
                  capacity_factor: float = 2.0,
                  capacity: Optional[int] = None) -> ExchangeSpec:
    """Sizes as JAX's: rows_per_shard padded to a multiple of 8; capacity
    `ceil(U / S) * factor` clamped to [8, U], U at S = 1, and an explicit
    `capacity` wins."""
    rows_per_shard = -(-num_rows // num_shards)
    rows_per_shard = -(-rows_per_shard // 8) * 8
    if capacity is None:
        if num_shards == 1:
            capacity = ids_per_step
        else:
            capacity = int(-(-ids_per_step // num_shards) * capacity_factor)
            capacity = min(max(capacity, 8), ids_per_step)
    return ExchangeSpec(num_shards=num_shards, rows_per_shard=rows_per_shard,
                        num_rows=num_rows, capacity=int(capacity))


class Route(NamedTuple):
    """One step's routing of this rank's unique ids. Dropped entries use
    the positive out-of-range sentinel S*C, never -1."""
    pos: torch.Tensor       # [U] int32 slot of each unique id in the send
                            #     buffer, S*C if dropped
    recv_ids: torch.Tensor  # [S, C] ids asked of this rank by each rank,
                            #     -1 in empty slots
    overflow: torch.Tensor  # [] int32: real ids dropped this step
    src: torch.Tensor       # [S*C] int64 unique index filling each send
                            #     slot, U where empty (the port's own: the
                            #     send buffers are read through it)


def _all_to_all(comm, x: torch.Tensor) -> torch.Tensor:
    """Exchange leading-axis blocks ([S, ...] on every rank)."""
    if comm is None or comm.size == 1:
        return x
    return comm.all_to_all(x)


def _local_slots(spec: ExchangeSpec, recv_ids: torch.Tensor) -> torch.Tensor:
    """Received ids -> owner-local slots, `rows_per_shard` where empty."""
    return torch.where(recv_ids >= 0,
                       torch.div(recv_ids, spec.num_shards,
                                 rounding_mode="floor"),
                       spec.rows_per_shard)


def route_ids(spec: ExchangeSpec, uniq_ids: torch.Tensor,
              valid: torch.Tensor, comm=None) -> Route:
    """Bucket this rank's unique ids by owner and exchange them. As JAX
    does: a stable sort by owner, each id's index within its owner's
    group, the first `capacity` of each group kept, so the same ids
    overflow in both packages."""
    S, C = spec.num_shards, spec.capacity
    U = uniq_ids.shape[0]
    dev = uniq_ids.device
    owner = torch.where(valid, torch.remainder(uniq_ids, S), S)
    sorted_owner, order = torch.sort(owner, stable=True)
    group_start = torch.searchsorted(sorted_owner, sorted_owner)
    idx_in_group = torch.arange(U, device=dev) - group_start
    real = sorted_owner < S
    ok = real & (idx_in_group < C)
    slot = torch.where(ok, sorted_owner * C + idx_in_group, S * C)
    # the slot -> unique map; every dropped entry lands on the spare slot
    src = torch.full((S * C + 1,), U, dtype=torch.long, device=dev)
    src = src.scatter_(0, slot, order)[:S * C]
    send_ids = torch.cat([uniq_ids, uniq_ids.new_full((1,), -1)])[src]
    pos = torch.empty(U, dtype=torch.int32, device=dev).scatter_(
        0, order, slot.to(torch.int32))
    overflow = (real & ~ok).sum().to(torch.int32)
    recv_ids = _all_to_all(comm, send_ids.view(S, C))
    return Route(pos=pos, recv_ids=recv_ids, overflow=overflow, src=src)


def owner_rows(spec: ExchangeSpec, table_shard: torch.Tensor, route: Route,
               comm=None) -> torch.Tensor:
    """Serve lookups: read the rows every rank asked of this one (one K1
    launch on the block, in its dtype) and all-to-all them back. Returns
    the requester's [S*C, D] buffer, send-slot order, zero where empty."""
    S, C = spec.num_shards, spec.capacity
    local = _local_slots(spec, route.recv_ids).reshape(-1)
    vecs = embedding_gather(table_shard, local)
    return _all_to_all(comm, vecs.view(S, C, -1)).view(S * C, -1)


def gather_rows(spec: ExchangeSpec, table_shard: torch.Tensor, route: Route,
                comm=None, out_dtype=None) -> torch.Tensor:
    """[U, D] rows aligned with the routed unique ids (zero rows for the
    dropped ones): `owner_rows`, then a K1 read of its buffer at `pos`,
    widened to `out_dtype` when given."""
    return embedding_gather(owner_rows(spec, table_shard, route, comm),
                            route.pos, out_dtype)


def rowquant_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization, JAX's bit for bit: scale =
    maxabs / 127 in x's dtype (1 for a zero row) as f32, q = round(x /
    scale) clipped to [-127, 127]. Dequant is q * scale."""
    m = x.abs().amax(dim=-1)
    scale = torch.where(m > 0, m / 127.0, torch.ones_like(m)).to(
        torch.float32)
    q = torch.clamp(torch.round(x / scale[..., None].to(x.dtype)),
                    -127, 127).to(torch.int8)
    return q, scale


def scatter_grads(
    spec: ExchangeSpec,
    route: Route,
    grad_uniq: torch.Tensor,                     # [U, D] summed per id
    comm=None,
    counts_uniq: Optional[torch.Tensor] = None,  # [U] duplicate counts
    wire_dtype=None,        # torch.bfloat16 / torch.int8 on the wire
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Reverse path: send the grads to their owners, dedup and sum there.

    Returns (local_rows [S*C], row_grads [S*C, D] in the grads' dtype,
    row_counts [S*C] int32 or None, row_mask [S*C]) on the owner: its
    unique local rows (sorted, then `rows_per_shard` in the spare slots)
    with their summed grads; masked entries are padding. The int8 wire
    sends per-row scales in a second all-to-all, the counts a third.
    K3 sums in f32 and rounds once to the grads' dtype; JAX sums in that
    dtype."""
    S, C = spec.num_shards, spec.capacity
    D = grad_uniq.shape[-1]
    send = embedding_gather(grad_uniq.contiguous(), route.src)
    if wire_dtype == torch.int8:
        q, scale = rowquant_int8(send)
        recv_q = _all_to_all(comm, q.view(S, C, D)).view(S * C, D)
        recv_sc = _all_to_all(comm, scale.view(S, C)).view(S * C)
        recv = (recv_q.to(grad_uniq.dtype)
                * recv_sc[:, None].to(grad_uniq.dtype))
    else:
        wd = wire_dtype or grad_uniq.dtype
        recv = _all_to_all(comm, send.to(wd).view(S, C, D)).view(
            S * C, D).to(grad_uniq.dtype)

    flat_ids = route.recv_ids.reshape(-1)
    present = flat_ids >= 0
    local = _local_slots(spec, flat_ids)
    # the same row may arrive from several ranks: dedup and sum; JAX's
    # fill is rows_per_shard, above every local slot, so the sorted
    # distinct slots come first in both
    uniq_local, inv = unique_static(local, S * C)
    uniq_local = torch.where(uniq_local < 0, spec.rows_per_shard, uniq_local)
    row_grads = segment_sum_grads(recv, torch.where(present, inv, S * C),
                                  S * C)
    row_counts = None
    if counts_uniq is not None:
        cnt = torch.cat([counts_uniq.to(torch.int32),
                         counts_uniq.new_zeros(1, dtype=torch.int32)])
        recv_cnt = _all_to_all(comm, cnt[route.src].view(S, C)).view(S * C)
        row_counts = torch.zeros(S * C, dtype=torch.int32,
                                 device=recv_cnt.device).index_add_(
            0, inv, recv_cnt)
    row_mask = uniq_local < spec.rows_per_shard
    return uniq_local, row_grads, row_counts, row_mask
