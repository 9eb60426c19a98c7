"""Ms a step of the card's idle time over the traced stretch in which
the thread that runs the chunks is in no `herald.*` span of the program,
or in the root span `herald.train.chunk`'s own time alone: the idle time
that the program's spans leave unexplained. Each part of each idle gap
is named by the innermost span open over it (`spans.py`). A faster span
lowers the idle it holds and leaves this as it is."""

from portbench import spans


def read(r):
    s = spans.of(r)
    if s is None or not r.traced.steps:
        return None
    return s.unexplained_s() / r.traced.steps * 1e3
