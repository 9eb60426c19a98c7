"""Host ms a step in the dispatch of steps over the traced stretch: the
program's span `herald.step.dispatch`, one a chunk around the replays of
its steps (`_run_chunk`, `_train_steps`), inclusive, on the profiler's
clock (`spans.py`)."""

from portbench import spans


def read(r):
    return spans.ms_per_step(r, "step.dispatch")
