"""Host ms a step in the pack of staged chunks over the traced stretch:
the program's span `herald.stage.pack`, inclusive of the memo
(`stage.memo`) and the copy's enqueue (`stage.copy`) inside it, on the
profiler's clock (`spans.py`)."""

from portbench import spans


def read(r):
    return spans.ms_per_step(r, "stage.pack")
