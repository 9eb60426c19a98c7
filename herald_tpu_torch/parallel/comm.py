"""The process group of the row-sharded engine and its collectives: what
JAX's mesh axis gives the hybrid engine for free (`lax.all_to_all`,
`lax.psum` and `axis_index_groups` inside `shard_map`).

`setup` joins the group of `torch.distributed.run` (its RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT), or one given
by an explicit `init_method` (a `file://` store in the tests), or a group
already initialized in the process. With none of them the world is one
rank and no group is made.

- Device: `cuda:LOCAL_RANK` unless the caller names one. A named index is
  the same card for every local rank (the launcher hands every rank the
  same `--device`), so two local ranks then share it.
- Backend, fixed before the group is made: `nccl` when the device is a
  card that no two local ranks share, `gloo` otherwise (the CPU, or ranks
  sharing a card, which NCCL refuses). Nothing falls back from one to the
  other.
- `all_to_all` moves [S, ...] blocks with equal splits as bytes (uint8
  views: gloo refuses int16 and bf16 needs no arithmetic), `all_reduce_`
  sums one flat buffer in place, `reduce_scatter` sums [S*b, ...] over the
  group and keeps this rank's block b (JAX's tiled `psum_scatter` over
  axis 0), `all_gather` stacks a tensor of every rank, `broadcast_` copies
  rank 0's tensors to every rank, `send` and `recv_` move one tensor
  from one rank to another, `barrier` waits for every rank,
  `host_group` a gloo twin of the group for another thread's host
  arrays, `split` the subgroup of a partition of the ranks that holds
  this rank (the dense-sync groups, the pipelines' groups), `grid` the
  mp and dp groups of a (dp, mp) layout (JAX's mesh axes,
  `herald_tpu/config.py:266-283`: flat rank dp_i * mp + mp_j), and
  `shift` moves a tensor one way round a ring (JAX's `lax.ppermute`).
  `all_gather` and `reduce_scatter` also work along any dimension (JAX's
  tiled `all_gather` and `psum_scatter`). At S = 1 each returns its
  input, and `barrier` returns at once. The split sizes are fixed, so no
  collective waits on the host to size itself.
  gloo takes CUDA tensors for every one of these (and copies them through
  host memory itself; `reduce_scatter_tensor` too, on an H100 with torch
  2.11: `chip_smoke.py`'s hybrid:scheduled leg calls it there), so every
  backend runs the same calls and this module stages nothing.
- Each collective adds its host seconds to `seconds`, for the profiles of
  `chip_smoke.py`; under gloo a call returns when its bytes have moved.
  It also adds the bytes of its result buffer on this rank to `bytes`,
  and one to `calls`, under the names of XLA's collectives that JAX's
  `utils/hlo_stats.py` counts in a compiled step: "all-to-all",
  "all-reduce", "reduce-scatter", "all-gather", "collective-broadcast"
  (each flat buffer a call sends), and "collective-permute" (what `send`
  sends, `recv_` receives and `shift` receives). At S = 1 nothing is
  counted: JAX compiles no collective there. A Comm of a subgroup
  (`split`, `grid`) adds to its parent's `seconds`, `bytes` and `calls`, so one
  step's count covers every group it used, as JAX's compiled step's
  does. `utils/hlo_stats.collective_bytes` reads them around one step.
- gloo's point-to-point calls take host tensors only: over gloo, `shift`
  moves a card's tensor through host memory (one copy each way).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def world_size() -> int:
    """The size of the group in place or about to be joined: the
    initialized group's, else `WORLD_SIZE` of the environment, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank_device(device, local_rank: int) -> torch.device:
    """The rank's device: `device`, or `cuda:LOCAL_RANK` when none (or a
    bare "cuda") is given. Raises when the card does not exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "herald_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"local rank {local_rank}: {dev} does not exist (this host "
                f"has {torch.cuda.device_count()} cards); to put every "
                f"local rank on one card name it, e.g. --device cuda:0")
    return dev


def choose_backend(dev: torch.device, shared: bool) -> str:
    """nccl for a card of the rank's own, gloo otherwise."""
    return "nccl" if dev.type == "cuda" and not shared else "gloo"


class Comm:
    """One rank's view of the group: its rank, the group's size, its
    device and the collectives over `group` (None: the default group)."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 backend: Optional[str], group=None):
        self.rank, self.size, self.device = rank, size, device
        self.backend, self.group = backend, group
        # the group's members as ranks of the default group
        self.ranks: List[int] = list(range(size))
        self.seconds: Dict[str, float] = {}
        self.bytes: Dict[str, int] = {}
        self.calls: Dict[str, int] = {}

    def _timed(self, name: str, t0: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + (
            time.perf_counter() - t0)

    def _count(self, kind: str, t: torch.Tensor) -> None:
        self.bytes[kind] = self.bytes.get(kind, 0) + t.numel() * \
            t.element_size()
        self.calls[kind] = self.calls.get(kind, 0) + 1

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Block i of x goes to rank i; block j of the result came from
        rank j. x is [S, ...]."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out.view(self.size, -1).view(torch.uint8),
                               x.view(self.size, -1).view(torch.uint8),
                               group=self.group)
        self._timed("all_to_all", t0)
        self._count("all-to-all", out)
        return out

    def all_reduce_(self, flat: torch.Tensor) -> torch.Tensor:
        """Sum `flat` over the group in place."""
        if self.size > 1:
            t0 = time.perf_counter()
            dist.all_reduce(flat, group=self.group)
            self._timed("all_reduce", t0)
            self._count("all-reduce", flat)
        return flat

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """[S*b, ...] -> [b, ...]: block `rank` of the sum of every rank's
        x; along `dim` when given (JAX's tiled `psum_scatter`)."""
        if self.size == 1:
            return x
        if dim % x.dim():
            return self.reduce_scatter(x.movedim(dim, 0)).movedim(0, dim)
        t0 = time.perf_counter()
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // self.size,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=self.group)
        self._timed("reduce_scatter", t0)
        self._count("reduce-scatter", out)
        return out

    def all_gather(self, x: torch.Tensor,
                   dim: Optional[int] = None) -> torch.Tensor:
        """[S, *x.shape]: every rank's x, in rank order; with `dim`, the
        ranks' x joined along it in rank order (JAX's tiled
        `all_gather`)."""
        if self.size == 1:
            return x[None] if dim is None else x
        t0 = time.perf_counter()
        x = x.contiguous()
        out = x.new_empty((self.size,) + tuple(x.shape))
        dist.all_gather(list(out.unbind(0)), x, group=self.group)
        self._timed("all_gather", t0)
        self._count("all-gather", out)
        if dim is None:
            return out
        return torch.cat(out.unbind(0), dim)

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Copy rank 0's tensors into every rank's, one call for each
        dtype (the tensors packed into one flat buffer)."""
        if self.size == 1:
            return
        t0 = time.perf_counter()
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, 0, group=self.group)
            self._count("collective-broadcast", flat)
            for t, v in zip(ts, torch.split(flat, [t.numel() for t in ts])):
                t.copy_(v.view(t.shape))
        self._timed("broadcast", t0)

    def send(self, x: torch.Tensor, dst: int) -> None:
        """Send x to rank `dst`, which takes it with `recv_`."""
        t0 = time.perf_counter()
        x = x.contiguous()
        dist.send(x, self.ranks[dst], group=self.group)
        self._timed("send", t0)
        self._count("collective-permute", x)

    def recv_(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Fill the contiguous x with what rank `src` sent."""
        t0 = time.perf_counter()
        dist.recv(x, self.ranks[src], group=self.group)
        self._timed("recv", t0)
        self._count("collective-permute", x)
        return x

    def shift(self, x: torch.Tensor, offset: int = 1) -> torch.Tensor:
        """x of rank (rank - offset) mod S: every rank sends its x to rank
        (rank + offset) mod S (JAX's `lax.ppermute` over the ring). The
        sends and receives are posted together and then waited on, so a
        ring of them cannot deadlock; every rank must call it."""
        if self.size == 1 or offset % self.size == 0:
            return x
        t0 = time.perf_counter()
        staged = self.backend == "gloo" and x.device.type != "cpu"
        src = (x.detach().cpu() if staged else x).contiguous()
        out = torch.empty_like(src)
        dst = self.ranks[(self.rank + offset) % self.size]
        frm = self.ranks[(self.rank - offset) % self.size]
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, src, dst, self.group),
                dist.P2POp(dist.irecv, out, frm, self.group)]):
            w.wait()
        self._timed("shift", t0)
        self._count("collective-permute", out)
        return out.to(x.device, non_blocking=True) if staged else out

    def barrier(self) -> None:
        """Wait until every rank of the group has called it (JAX's
        `multihost_utils.sync_global_devices`)."""
        if self.size > 1:
            dist.barrier(group=self.group)

    def host_group(self) -> "Comm":
        """A Comm of the same ranks over a gloo group of its own, for host
        arrays: collectives made from another thread (the scheduled
        launcher's planner) then never interleave with this group's, and
        its `seconds` are its own. Every rank makes it, in the same order
        as every other group."""
        cpu = torch.device("cpu")
        if self.size == 1:
            return Comm(self.rank, 1, cpu, None)
        return Comm(self.rank, self.size, cpu, "gloo",
                    dist.new_group(backend="gloo"))

    def _sub(self, ranks: List[int], group) -> "Comm":
        """A Comm over `group`, whose members are `ranks` of this one,
        counting into this Comm's `seconds`, `bytes` and `calls`."""
        c = Comm(ranks.index(self.rank), len(ranks), self.device,
                 self.backend, group)
        c.ranks = [self.ranks[r] for r in ranks]
        c.seconds, c.bytes, c.calls = self.seconds, self.bytes, self.calls
        return c

    def grid(self, mp: int) -> Tuple["Comm", "Comm"]:
        """(mp Comm, dp Comm) of the (S / mp, mp) layout: the mp group is
        this rank's mp consecutive ranks, the dp group the ranks spaced mp
        apart from it (JAX's mesh `(dp, mp)`, flat rank dp_i * mp + mp_j).
        Every rank makes every group, the mp groups first, in one order.
        A group of one rank is made by no call."""
        if self.size % mp:
            raise ValueError(f"{self.size} devices not divisible by "
                             f"mp_shards={mp}")
        dp = self.size // mp
        return (self.split([list(range(i * mp, (i + 1) * mp))
                            for i in range(dp)]),
                self.split([list(range(j, self.size, mp))
                            for j in range(mp)]))

    def split(self, groups: List[List[int]]) -> "Comm":
        """The Comm of the group, of `groups` (lists of this Comm's ranks
        that cover it once), that holds this rank; it counts into this
        Comm's counters. Every rank makes every group, in the order
        given; a group of one rank is made by no call."""
        mine = None
        for g in groups:
            pg = dist.new_group([self.ranks[r] for r in g]) \
                if len(g) > 1 else None
            if self.rank in g:
                mine = self._sub(list(g), pg)
        return mine


def setup(device=None, init_method: Optional[str] = None,
          rank: Optional[int] = None,
          world_size: Optional[int] = None) -> Comm:
    """This rank's Comm, joining or making the process group (see the
    module's docstring). `rank` and `world_size` go with `init_method`;
    without it they come from the environment."""
    env = os.environ
    if dist.is_initialized():
        r, size = dist.get_rank(), dist.get_world_size()
        dev = rank_device(device, int(env.get("LOCAL_RANK", r)))
        return Comm(r, size, dev, dist.get_backend())
    if init_method is None and "WORLD_SIZE" not in env:
        return Comm(0, 1, rank_device(device, 0), None)
    r = int(env["RANK"]) if rank is None else rank
    size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    local_rank = int(env.get("LOCAL_RANK", r))
    local_size = int(env.get("LOCAL_WORLD_SIZE", size))
    dev = rank_device(device, local_rank)
    named = device is not None and torch.device(device).index is not None
    backend = choose_backend(dev, shared=named and local_size > 1)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, rank=r,
                            world_size=size, **kw)
    return Comm(r, size, dev, backend)
