"""Exchange-capacity sizing from measured planner traffic (the port's own
copy of `herald_tpu/sched/sizing.py`: numpy over the port's
`CachePlanner`; the sweeps build the port's `CachedEngine` on the CPU,
only for its caps and planner).

Herald's communication win is *planned*, so it can be turned into smaller
static all-to-all buffers: a measuring pass pops every micro-program,
buckets each step's pulls/flushes by owner shard exactly the way the device
router does (`parallel/exchange.py route_ids`: owner = id % num_shards),
and records per-step per-(worker, owner) bucket maxima. The training engine
is then rebuilt with capacities just above the steady-state maxima; the
compiled HLO moves proportionally fewer bytes (utils/hlo_stats.py measures
them) and the runtime overflow counter certifies that nothing was dropped.

Cold start: the first few steps miss everything (empty caches), so their
pull buckets match the no-cache baseline. Sizing to that worst case would
erase the win — instead the run executes the first `warmup` steps on a
wide-capacity compiled step and the rest on the tight steady-state step
(two XLA executables over the same state shapes; swapping programs between
scan chunks is free).

Reference analog: the PS never had static buffers (ZMQ messages are
variable-length), so its win showed up only in logged bytes
(`PSAgent.h:478-483`); on TPU the same win must be compiled into the
buffer shapes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from herald_tpu_torch.sched.planner import CachePlanner, StepProgram


@dataclasses.dataclass
class StepTraffic:
    """One step's routed traffic (maxima over workers)."""
    pull_bucket: int       # largest per-(worker, owner) pull bucket
    flush_bucket: int      # largest per-(worker, owner) flush bucket
    pulls: int             # total pulled rows (all workers)
    flushes: int           # total flushed rows (all workers)
    pull_worker: int = 0   # largest single-worker pull count
    flush_worker: int = 0  # largest single-worker flush count
    uniq_worker: int = 0   # largest single-worker unique-key count


@dataclasses.dataclass
class TrafficProfile:
    """Worst-case per-(worker, owner) bucket sizes over a planned stream."""
    max_pull_bucket: int
    max_flush_bucket: int
    steps: int
    total_pulls: int
    total_flushes: int
    max_pull_worker: int = 0
    max_flush_worker: int = 0
    max_uniq_worker: int = 0
    mean_pull_bucket: float = 0.0   # mean over steps of the per-step max

    @classmethod
    def from_steps(cls, steps: List[StepTraffic]) -> "TrafficProfile":
        return cls(
            max_pull_bucket=max((s.pull_bucket for s in steps), default=0),
            max_flush_bucket=max((s.flush_bucket for s in steps), default=0),
            steps=len(steps),
            total_pulls=sum(s.pulls for s in steps),
            total_flushes=sum(s.flushes for s in steps),
            max_pull_worker=max((s.pull_worker for s in steps), default=0),
            max_flush_worker=max((s.flush_worker for s in steps),
                                 default=0),
            max_uniq_worker=max((s.uniq_worker for s in steps), default=0),
            mean_pull_bucket=float(np.mean([s.pull_bucket for s in steps]))
            if steps else 0.0)

    def pull_capacity(self, align: int = 8, headroom: float = 1.25) -> int:
        """Safe per-(src,dst) pull capacity: measured max + headroom.

        Headroom covers plan drift when the run's planner defers flushes
        differently under the tightened owner cap (deferral shifts which
        step a row refreshes in); the engine's overflow counter remains
        the hard check.
        """
        need = int(np.ceil(self.max_pull_bucket * headroom))
        return max(-(-need // align) * align, align)

    def flush_capacity(self, align: int = 8, headroom: float = 1.25) -> int:
        need = int(np.ceil(self.max_flush_bucket * headroom))
        return max(-(-need // align) * align, align)

    def flush_slots(self, align: int = 8, headroom: float = 1.5) -> int:
        """Per-worker flush-array length (`HeraldConfig.sched_flush_slots`):
        measured max single-worker flush count + headroom. The planner
        raises rather than truncate if a run ever exceeds it."""
        need = int(np.ceil(self.max_flush_worker * headroom))
        return max(-(-need // align) * align, align)

    def pull_target(self, headroom: float = 1.15) -> int:
        """Hoisting target (HeraldConfig.sched_pull_target): a little
        above the MEAN per-step max bucket — the planner hoists the
        above-target tail into underfull steps, and pull_capacity can
        then be sized to ~this target instead of the max."""
        return max(int(np.ceil(self.mean_pull_bucket * headroom)), 1)

    def hoisted_pull_capacity(self, align: int = 8,
                              headroom: float = 1.25) -> int:
        """Pull capacity when hoisting toward pull_target(): target +
        headroom, but never worse than the max-based cap (mean-based
        sizing only helps when buckets are bursty)."""
        need = int(np.ceil(self.pull_target() * headroom))
        cap_t = max(-(-need // align) * align, align)
        return min(self.pull_capacity(align, headroom), cap_t)

    def unique_slots(self, align: int = 8, headroom: float = 1.15) -> int:
        """Per-worker unique-key capacity (HeraldConfig.sched_unique_slots):
        the width of every dedup/cache pass in the compiled step. Uniques
        are a property of the data (stable across epochs), so headroom is
        thin; the planner raises rather than truncate."""
        need = int(np.ceil(self.max_uniq_worker * headroom))
        return max(-(-need // align) * align, align)


def step_traffic(prog: StepProgram, sparse_ids: np.ndarray,
                 num_shards: int) -> StepTraffic:
    """Reproduce the device's per-step owner bucketing for one program."""
    nrank = prog.assign.shape[0]
    pull_b = flush_b = pulls = flushes = pull_w = flush_w = uniq_w = 0
    for z in range(nrank):
        # device-side key order: sorted unique of the assigned batch
        keys = np.unique(sparse_ids[prog.assign[z]].ravel())
        uniq_w = max(uniq_w, len(keys))
        pull_keys = keys[prog.pulls[z, : len(keys)]]
        # hoisted prefetches ride THIS step's pull route: count them in
        # the same buckets
        if prog.prefetch_ids is not None:
            pf = prog.prefetch_ids[z]
            pull_keys = np.concatenate([pull_keys, pf[pf >= 0]])
        if len(pull_keys):
            buckets = np.bincount(pull_keys % num_shards,
                                  minlength=num_shards)
            pull_b = max(pull_b, int(buckets.max()))
            pull_w = max(pull_w, len(pull_keys))
            pulls += len(pull_keys)
        fids = prog.flush_ids[z]
        fids = fids[fids >= 0]
        if len(fids):
            buckets = np.bincount(fids % num_shards,
                                  minlength=num_shards)
            flush_b = max(flush_b, int(buckets.max()))
            flush_w = max(flush_w, len(fids))
            flushes += len(fids)
    return StepTraffic(pull_bucket=pull_b, flush_bucket=flush_b,
                       pulls=pulls, flushes=flushes,
                       pull_worker=pull_w, flush_worker=flush_w,
                       uniq_worker=uniq_w)


def hoist_target_candidates(steady: TrafficProfile, nrank: int,
                            num_shards: int) -> List[int]:
    """Sweep points for `sweep_hoist_sizing`: the per-bucket MEAN load
    (the leveling floor — with the planner's leveling rule a low target
    just means "keep leveling until buckets are balanced"), the classic
    mean-of-step-max target, and their midpoint."""
    t_hi = steady.pull_target()
    denom = max(steady.steps * nrank * num_shards, 1)
    t_lo = max(1, int(np.ceil(steady.total_pulls / denom)))
    t_lo = min(t_lo, t_hi)
    return sorted({t_lo, (t_lo + t_hi) // 2, t_hi})


def sweep_hoist_sizing(cfg, table_rows: int, sparse_ids: np.ndarray,
                       num_shards: int, warmup: int,
                       targets: List[int], epochs: int = 1,
                       n_threads: Optional[int] = None
                       ) -> Tuple[int, TrafficProfile]:
    """Probe-plan the HOISTED stream at each candidate pull target and
    return (best_target, its steady TrafficProfile), minimizing the
    certified post-hoist pull capacity (ties -> the larger target: fewer
    hoists, less prefetch churn, same wire width).

    Honest by construction: the planner is deterministic, so each probe
    stream IS the stream the training run will execute at that target —
    the returned profile's `pull_capacity()` cannot overflow. This
    replaces the guess-based `hoisted_pull_capacity` (target*headroom),
    which under-covers whenever a peak is taller than the hoist window
    can absorb.
    """
    from herald_tpu_torch.config import HeraldConfig  # lazy: avoid cycle
    from herald_tpu_torch.train.cached import CachedEngine

    best: Optional[Tuple[int, int, TrafficProfile]] = None
    for t in sorted(set(int(t) for t in targets), reverse=True):
        probe_cfg = HeraldConfig(**{**cfg.__dict__,
                                    "sched_pull_target": t,
                                    "a2a_pull_capacity": None,
                                    "a2a_flush_capacity": None})
        eng = CachedEngine(probe_cfg, table_rows=table_rows,
                           device="cpu")
        kw = {} if n_threads is None else {"n_threads": n_threads}
        pl = eng.make_planner(sparse_ids, epochs=epochs, **kw)
        steps, _ = profile_planned_traffic(pl, sparse_ids, num_shards)
        pl.close()
        prof = TrafficProfile.from_steps(steps[warmup:])
        cap = prof.pull_capacity()
        if best is None or cap < best[1]:
            best = (t, cap, prof)
    assert best is not None, "sweep_hoist_sizing needs >=1 target"
    return best[0], best[2]


def sweep_flush_budget(cfg, table_rows: int, sparse_ids: np.ndarray,
                       num_shards: int, warmup: int,
                       wide_profile: TrafficProfile, epochs: int = 1,
                       n_threads: Optional[int] = None
                       ) -> Tuple[Optional[int], TrafficProfile]:
    """Probe-plan at a few planned-flush budgets (cfg.sched_flush_budget)
    and return (best_budget, its steady TrafficProfile), minimizing the
    summed pull+flush wire capacity (both exchanges ship ~the same bytes
    per row, so the cap sum is the byte proxy; ties -> the larger budget:
    less deferral, fresher rows).

    A tighter budget defers planned flushes (rows stay dirty longer —
    the reference's bounded-staleness trade, run_laia.py --bound), which
    cuts the flush-bucket maxima AND, measured, the pull totals (a later
    flush carries more coalesced updates). Mandatory flushes (eviction +
    stale-refresh) ignore the budget, so the measured max — which sizes
    the wire — can sit above it. Honest like sweep_hoist_sizing: the
    probed stream IS the execution stream at that budget.
    """
    from herald_tpu_torch.config import HeraldConfig  # lazy: avoid cycle
    from herald_tpu_torch.train.cached import CachedEngine

    wide_max = max(wide_profile.max_flush_bucket, 1)
    cands = sorted({max(1, int(np.ceil(wide_max * f)))
                    for f in (0.2, 0.35, 0.5)})
    best: Optional[Tuple[Optional[int], int, TrafficProfile]] = \
        (None, wide_profile.pull_capacity() + wide_profile.flush_capacity(),
         wide_profile)
    for budget in sorted(cands, reverse=True):
        probe_cfg = HeraldConfig(**{**cfg.__dict__,
                                    "sched_flush_budget": int(budget),
                                    "a2a_pull_capacity": None,
                                    "a2a_flush_capacity": None})
        eng = CachedEngine(probe_cfg, table_rows=table_rows,
                           device="cpu")
        kw = {} if n_threads is None else {"n_threads": n_threads}
        pl = eng.make_planner(sparse_ids, epochs=epochs, **kw)
        steps, _ = profile_planned_traffic(pl, sparse_ids, num_shards)
        pl.close()
        prof = TrafficProfile.from_steps(steps[warmup:])
        cost = prof.pull_capacity() + prof.flush_capacity()
        if cost < best[1]:
            best = (int(budget), cost, prof)
    return best[0], best[2]


def profile_planned_traffic(planner: CachePlanner, sparse_ids: np.ndarray,
                            num_shards: int,
                            keep_programs: bool = False
                            ) -> Tuple[List[StepTraffic],
                                       List[StepProgram]]:
    """Drain `planner`, returning per-step traffic (and optionally the
    popped programs). `sparse_ids` must be the same [N, F] id matrix the
    planner was built over. Split the result at your warmup boundary:
    `TrafficProfile.from_steps(steps[w:])` sizes the steady-state program,
    `from_steps(steps[:w])` the cold-start program."""
    out: List[StepTraffic] = []
    programs: List[StepProgram] = []
    while True:
        prog = planner.pop()
        if prog is None:
            break
        out.append(step_traffic(prog, sparse_ids, num_shards))
        if keep_programs:
            programs.append(prog)
    return out, programs


def profile_baseline_traffic(sparse_ids: np.ndarray, batch_size: int,
                             nrank: int,
                             max_steps: Optional[int] = None,
                             num_shards: Optional[int] = None
                             ) -> TrafficProfile:
    """Same bucketing for the un-cached baseline engine: every unique key
    of a worker's batch is pulled AND its gradient pushed every step
    (contiguous global batches split across workers, Engine.train_epoch
    order). `num_shards` is the owner-shard count for bucketing (defaults
    to nrank, the usual worker==shard SPMD layout)."""
    gb = batch_size * nrank
    S = num_shards or nrank
    n_steps = len(sparse_ids) // gb
    if max_steps is not None:
        n_steps = min(n_steps, max_steps)
    max_b = total = 0
    for s in range(n_steps):
        batch = sparse_ids[s * gb:(s + 1) * gb]
        for z in range(nrank):
            keys = np.unique(batch[z * batch_size:(z + 1) * batch_size]
                             .ravel())
            buckets = np.bincount(keys % S, minlength=S)
            max_b = max(max_b, int(buckets.max()))
            total += len(keys)
    return TrafficProfile(
        max_pull_bucket=max_b, max_flush_bucket=max_b,
        steps=n_steps, total_pulls=total, total_flushes=total)
