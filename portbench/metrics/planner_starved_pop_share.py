"""Percent of the traced stretch's pops that found fewer programs in the
planner's queue than they took, from the program's `planner.pop` span
records (`spans.records`, `queue_before` against `K`): how often the
steps caught up with the planner and waited for it."""

from portbench import spans


def read(r):
    return spans.starved_pop_share(spans.records(r))
