"""Percent of the traced stretch in which no operation ran on the card:
1 - the union of the device's operations over the stretch's length."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
