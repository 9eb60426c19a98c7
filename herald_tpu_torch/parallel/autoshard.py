"""Bounded auto-parallel layout search (port of
`herald_tpu/parallel/autoshard.py`).

The space is the (dp, mp) layouts of the ranks of the current group
(`parallel/comm.setup`): every mp that divides S, with the Megatron
tower where the model carries a `tp_plan`. Each candidate is an `Engine`
at that mp; one that cannot host it (no TP tower, a width mp does not
divide) is kept in the table with its reason, as JAX keeps it. Each
valid candidate runs one train step on `example_step_args`, and:

- its collective bytes are what the step's `Comm` calls moved on this
  rank, by XLA's kind names (`utils/hlo_stats.collective_bytes`), where
  JAX parses the compiled program's HLO;
- its FLOPs are what `torch.utils.flop_counter.FlopCounterMode` counts in
  that step, forward and backward: matrix products only (mm, addmm, bmm,
  convolutions), where XLA's `cost_analysis` also counts the elementwise
  and reduction ops. The port's counts are lower for that reason.

Each candidate's state is freed before the next one is built. The score
is JAX's roofline: the wire bytes (`_wire_bytes`: a group-g collective
moves (g - 1) / g of its buffer; the all-to-all over all S ranks, the
gathers and reduce-scatters over the mp group, the all-reduces over the
dp group) over the link rate, against the FLOPs over the peak rate, and
a step costs the larger of the two. The defaults are the H100's own:
`link_gbps` 450 GB/s, NVLink's rate each way, where JAX's `ici_gbps`
defaults to a TPU's links, and `peak_tflops` 67 TFLOP/s, the H100 SXM's
f32 peak without tensor cores (the tower runs in f32 with TF32 off),
where JAX's `mxu_tflops` defaults to a TPU's matrix units.

`python -m herald_tpu_torch.parallel.autoshard MODEL` runs on one rank or
under `torch.distributed.run` (every rank searches; rank 0 prints the
audit table and the choice).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from herald_tpu_torch.config import HeraldConfig
from herald_tpu_torch.utils import hlo_stats


@dataclasses.dataclass
class LayoutScore:
    """One candidate layout and its roofline decomposition."""
    mp_shards: int
    valid: bool                 # False: model/tower cannot host this mp
    reason: str = ""
    a2a_bytes: int = 0          # embedding exchange (per rank per step)
    other_coll_bytes: int = 0   # all-reduce, all-gather etc. (dense, TP)
    flops: float = 0.0          # per rank per step (matrix products)
    comm_us: float = 0.0
    compute_us: float = 0.0
    step_us: float = 0.0        # max(comm, compute)


def _wire_bytes(coll: dict, num_shards: int, dp: int,
                mp: int) -> Tuple[int, int]:
    """(a2a, other) bytes that cross links, JAX's formula by collective
    kind: a group-g collective moves (g - 1) / g of its buffer; the
    all-to-all runs over all S ranks, the all-gathers, reduce-scatters
    and permutes over the mp group and the all-reduces over the dp group
    (over all S at mp = 1)."""
    def f(g):
        return (g - 1) / g if g > 1 else 0.0

    a2a = int(coll.get("all-to-all", 0) * f(num_shards))
    gather = sum(coll.get(k, 0) for k in ("all-gather", "reduce-scatter",
                                          "collective-permute"))
    allred = coll.get("all-reduce", 0)
    other = int(gather * f(mp if mp > 1 else num_shards)
                + allred * f(dp if mp > 1 else num_shards))
    return a2a, other


def _step_counts(eng) -> Tuple[dict, float]:
    """(collective bytes by kind, FLOPs) of one train step of `eng` on
    its zero args, from a fresh state that is freed after."""
    from torch.utils.flop_counter import FlopCounterMode
    state = eng.init_state(0)
    with FlopCounterMode(display=False) as fc:
        coll = hlo_stats.collective_bytes(
            eng._train_step_body, state, *eng.example_step_args(),
            comm=eng.comm)
    del state
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
        torch.cuda.empty_cache()
    return coll, float(fc.get_total_flops())


def search_layout(model: str, batch_size: int = 256,
                  embedding_dim: int = 128,
                  table_rows: Optional[int] = None,
                  link_gbps: float = 450.0, peak_tflops: float = 67.0,
                  device=None) -> Tuple[HeraldConfig, List[LayoutScore]]:
    """Enumerate the (dp, mp) layouts of `model` over the S ranks of the
    group, run one train step of each, score it on the roofline and
    return (the best HeraldConfig, every score). Every rank of the group
    must call it; each gets the same table."""
    from herald_tpu_torch.parallel.comm import setup
    from herald_tpu_torch.train.engine import Engine

    n = setup(device).size
    scores: List[LayoutScore] = []
    for mp in [m for m in range(1, n + 1) if n % m == 0]:
        cfg = HeraldConfig(model=model, batch_size=batch_size,
                           embedding_dim=embedding_dim, comm_mode="hybrid",
                           mp_shards=mp)
        try:
            eng = Engine(cfg, table_rows=table_rows, device=device,
                         cuda_graphs=False)
        except ValueError as e:    # no TP tower / width not divisible
            scores.append(LayoutScore(mp_shards=mp, valid=False,
                                      reason=str(e).split(";")[0]))
            continue
        coll, flops = _step_counts(eng)
        a2a, other = _wire_bytes(coll, eng.num_shards, eng.dp_shards, mp)
        comm_us = (a2a + other) / (link_gbps * 1e3)     # bytes/GBps -> us
        compute_us = flops / (peak_tflops * 1e6)
        scores.append(LayoutScore(
            mp_shards=mp, valid=True, a2a_bytes=a2a,
            other_coll_bytes=other, flops=flops, comm_us=comm_us,
            compute_us=compute_us, step_us=max(comm_us, compute_us)))
        del eng
    valid = [s for s in scores if s.valid]
    if not valid:
        raise ValueError(f"no valid layout for {model} on {n} devices")
    best = min(valid, key=lambda s: (s.step_us, s.mp_shards))
    return HeraldConfig(model=model, batch_size=batch_size,
                        embedding_dim=embedding_dim, comm_mode="hybrid",
                        mp_shards=best.mp_shards), scores


def format_table(cfg: HeraldConfig, scores: List[LayoutScore]) -> str:
    """JAX's audit table and the choice, as `main` prints them."""
    lines = [f"{'mp':>4} {'a2a B':>12} {'other B':>12} {'comm us':>9} "
             f"{'compute us':>11} {'step us':>9}"]
    for s in scores:
        if not s.valid:
            lines.append(f"{s.mp_shards:>4} invalid: {s.reason}")
            continue
        lines.append(f"{s.mp_shards:>4} {s.a2a_bytes:>12} "
                     f"{s.other_coll_bytes:>12} {s.comm_us:>9.2f} "
                     f"{s.compute_us:>11.2f} {s.step_us:>9.2f}")
    lines.append(f"chosen: mp_shards={cfg.mp_shards}")
    return "\n".join(lines)


def main(argv=None):
    """`python -m herald_tpu_torch.parallel.autoshard MODEL` — on one rank
    or under torch.distributed.run; rank 0 prints the scored layout table
    and the chosen config."""
    import argparse
    import torch.distributed as dist
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("model")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--embedding-size", type=int, default=128)
    p.add_argument("--rows", type=int, default=None)
    p.add_argument("--link-gbps", type=float, default=450.0,
                   help="link rate each way in GB/s (JAX's --ici-gbps); "
                        "default: the H100's NVLink")
    p.add_argument("--peak-tflops", type=float, default=67.0,
                   help="f32 peak in TFLOP/s (JAX's --mxu-tflops); "
                        "default: the H100 SXM without tensor cores")
    p.add_argument("--device", default=None,
                   help="cpu, or a card (default: the rank's own)")
    args = p.parse_args(argv)
    cfg, scores = search_layout(
        args.model, batch_size=args.batch_size,
        embedding_dim=args.embedding_size, table_rows=args.rows,
        link_gbps=args.link_gbps, peak_tflops=args.peak_tflops,
        device=args.device)
    if not (dist.is_initialized() and dist.get_rank() > 0):
        print(format_table(cfg, scores), flush=True)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    main()
