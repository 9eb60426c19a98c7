"""Run configuration (PyTorch port of `herald_tpu/config.py`).

Every field of the JAX package's `HeraldConfig` is kept with the same
default, so a `--save-config` JSON written by either package loads in the
other. Dtype fields hold torch dtypes here; the JSON stores their names
("float32", "bfloat16"). `mesh_shape` and `mesh_axes` are inert in the port
(there is no JAX mesh); they stay so that the JSON round-trips.
`device` is the port's own field: where the engine places its tensors
(None = "cuda", raising if there is no card). It is a run-time choice, not
part of the saved run configuration, so `to_json` leaves it out.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Sequence

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


# the flush wire's dtypes (`flush_wire_dtype`): the value dtypes and int8
_WIRE_DTYPES = {**_DTYPES, "int8": torch.int8}


def dtype_from_name(name: str, known=_DTYPES) -> torch.dtype:
    if name not in known:
        raise ValueError(f"unsupported dtype {name!r}; known: {sorted(known)}")
    return known[name]


def dtype_name(dtype: torch.dtype, known=_DTYPES) -> str:
    names = {v: k for k, v in known.items()}
    if dtype not in names:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return names[dtype]


@dataclasses.dataclass
class HeraldConfig:
    """Engine configuration; field meanings as in `herald_tpu/config.py`."""

    # --- model / data ---
    model: str = "wdl_criteo"
    batch_size: int = 256                 # per-device batch size
    embedding_dim: int = 128
    dtype: Any = torch.float32            # dense compute dtype
    table_dtype: Any = torch.float32      # embedding table dtype

    # --- optimizer ---
    optimizer: str = "sgd"
    learning_rate: float = 0.01
    lr_schedule: str = "constant"
    lr_schedule_kwargs: Optional[dict] = None
    embed_optimizer: Optional[str] = None
    embed_learning_rate: Optional[float] = None

    # --- parallelism ---
    comm_mode: str = "local"              # 'local' | 'hybrid'
    mesh_shape: Optional[Sequence[int]] = None
    mesh_axes: Sequence[str] = ("dp",)
    mp_shards: int = 1
    a2a_capacity_factor: float = 2.0
    a2a_pull_capacity: Optional[int] = None
    a2a_flush_capacity: Optional[int] = None
    sched_flush_slots: Optional[int] = None
    sched_unique_slots: Optional[int] = None
    sched_pull_target: Optional[int] = None
    sched_hoist_window: int = 8
    sched_prefetch_slots: Optional[int] = None
    sched_flush_budget: Optional[int] = None
    sched_noflush_variant: bool = True
    sched_nopull_variant: bool = True
    sched_packed_wire: bool = True
    sched_chunk_memo: bool = True
    sched_chunk_memo_mb: int = 256
    flush_wire_dtype: Any = None
    # the JAX package's opt-in Pallas gather; the port's gather always
    # runs its CUDA kernel on the card, so this is kept for the JSON only
    use_pallas_gather: bool = False

    # --- dense-sync relaxation ---
    dense_sync_every: int = 1
    dense_sync_group: int = 0

    # --- hot-row cache ---
    use_cache: bool = False
    cache_policy: str = "lru"
    cache_limit_ratio: float = 0.1
    pinned_rows: int = 0
    cache_limit: Optional[int] = None
    staleness_bound: int = 0

    # --- lookahead scheduler ---
    use_scheduler: bool = False
    sched_queue_size: int = 64
    sched_top_k_tables: Optional[int] = None
    sched_threads: int = 8
    sched_shuffle_seed: int = 0

    # --- runtime ---
    seed: int = 0
    log_dir: Optional[str] = None
    prefetch: bool = True
    device: Optional[str] = None

    def __post_init__(self):
        # JSON turns tuples into lists; keep one form so a round trip
        # gives an equal config
        self.mesh_axes = tuple(self.mesh_axes)
        if self.mesh_shape is not None:
            self.mesh_shape = tuple(self.mesh_shape)
        if self.embed_optimizer is None:
            self.embed_optimizer = self.optimizer
        if self.embed_learning_rate is None:
            self.embed_learning_rate = self.learning_rate
        if self.dense_sync_every < 1:
            raise ValueError("dense_sync_every must be >= 1")
        if self.dense_sync_group < 0:
            raise ValueError("dense_sync_group must be >= 0 (0 = full axis)")
        if self.dense_sync_every > 1 or self.dense_sync_group > 0:
            if self.comm_mode != "hybrid":
                raise ValueError(
                    "dense_sync_every/_group relax the dp dense-grad "
                    "all-reduce; they require comm_mode='hybrid'")
            if self.mp_shards > 1:
                raise ValueError(
                    "dense-sync relaxation is dp-only: the Megatron tower's "
                    "in-layer psums are part of the forward math and cannot "
                    "be made stale")
        if self.mp_shards > 1:
            if self.comm_mode != "hybrid":
                raise ValueError("mp_shards > 1 requires comm_mode='hybrid'")
            if self.use_cache or self.use_scheduler:
                raise ValueError(
                    "mp_shards > 1 composes with the plain hybrid engine "
                    "only; the cached/scheduled path is dp-only")
            if self.optimizer == "lamb":
                raise ValueError(
                    "lamb's full-tensor trust ratio needs global norms, "
                    "which the mp-sharded dense tower does not reduce; use "
                    "an elementwise dense optimizer with mp_shards > 1")

    def cache_rows(self, table_rows: int) -> int:
        if self.cache_limit is not None:
            return int(self.cache_limit)
        return max(1, int(table_rows * self.cache_limit_ratio))

    # ------------------------------------------------------------------
    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        del d["device"]
        d["dtype"] = dtype_name(self.dtype)
        d["table_dtype"] = dtype_name(self.table_dtype)
        d["flush_wire_dtype"] = (dtype_name(self.flush_wire_dtype,
                                            _WIRE_DTYPES)
                                 if self.flush_wire_dtype is not None
                                 else None)
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "HeraldConfig":
        d = json.loads(s)
        d["dtype"] = dtype_from_name(d["dtype"])
        d["table_dtype"] = dtype_from_name(d["table_dtype"])
        if d.get("flush_wire_dtype"):
            d["flush_wire_dtype"] = dtype_from_name(d["flush_wire_dtype"],
                                                    _WIRE_DTYPES)
        return cls(**d)
