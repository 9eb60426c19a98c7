"""Host ms a step in the planner's `pop_chunk` over the traced stretch,
from the program's own span `herald.planner.pop` (inclusive: the pop's
allocation and its C call, the wait for the planner's programs in it),
on the profiler's clock (`spans.py`)."""

from portbench import spans


def read(r):
    return spans.ms_per_step(r, "planner.pop")
