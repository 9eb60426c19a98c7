"""Host ms a step in `_chunk_program` over the traced stretch: the
self time of the program's span `herald.stage.program` (the chunk's
step inputs and write lists), on the profiler's clock (`spans.py`)."""

from portbench import spans


def read(r):
    return spans.ms_per_step(r, "stage.program", own=True)
