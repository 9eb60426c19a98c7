"""The planner's own planning ms a batch over the traced stretch, from
the program's `planner.pop` span records (`spans.records`): the change
of the planner's cumulative planning time (`phase_times_us`, read after
each pop) between the stretch's first and last pop, over the change of
the batches it had planned (the programs popped, plus those queued
before each pop). Hoisting, which would hold planned programs back from
the queue, is off at the cell's defaults (no pull target)."""

from portbench import spans


def read(r):
    return spans.plan_ms_per_batch(spans.records(r))
