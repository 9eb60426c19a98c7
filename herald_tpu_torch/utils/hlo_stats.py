"""Collective-traffic accounting (port of `herald_tpu/utils/hlo_stats.py`).

JAX reads the bytes a step moves off its compiled program: every
collective's result buffer is a static shape in the optimized HLO. torch
compiles no such program, so the port counts instead: each collective of
`parallel/comm.py`'s `Comm` adds the bytes of its result buffer on this
rank to `Comm.bytes` under the names of XLA's collectives, and
`collective_bytes` runs one step and returns what it added. The
convention is JAX's: the full per-rank result buffer of each collective
(for an all-to-all, (S-1)/S of it crosses links), so the two packages'
counts and the reductions between them compare directly. At S = 1
nothing is counted, as JAX compiles no collective there.

JAX's `parse_collective_bytes` and `compiled_text` read XLA text and have
no counterpart here.
"""

from __future__ import annotations

from typing import Dict

KINDS = ("all-to-all", "all-reduce", "all-gather", "reduce-scatter",
         "collective-permute", "collective-broadcast")


def collective_bytes(step_fn, *args, comm, **kwargs) -> Dict[str, int]:
    """Bytes a rank's collectives moved in one call of step_fn(*args,
    **kwargs), by kind, and their number of calls under "count", as
    JAX's `collective_bytes` returns them. Every rank of `comm` must make
    the call (the step's collectives are entered by all)."""
    before, calls = dict(comm.bytes), dict(comm.calls)
    step_fn(*args, **kwargs)
    out: Dict[str, int] = {k: comm.bytes.get(k, 0) - before.get(k, 0)
                           for k in KINDS}
    out["count"] = {k: comm.calls[k] - calls.get(k, 0)  # type: ignore
                    for k in comm.calls if comm.calls[k] > calls.get(k, 0)}
    return out


def exchange_a2a_bytes(spec, id_bytes: int = 4, vec_bytes: int = 4,
                       directions: int = 2) -> int:
    """Analytic all-to-all bytes of one `route_ids` + data exchange on an
    ExchangeSpec: the id buffer [S, C] plus `directions` data buffers
    [S, C, W] (1 = gather-only or scatter-only, 2 = both). `vec_bytes` is
    width * dtype-size."""
    S, C = spec.num_shards, spec.capacity
    return S * C * id_bytes + directions * S * C * vec_bytes
