"""Device busy ms a request over the traced stretch."""


def read(r):
    if r.trace is None or not r.traced.units:
        return None
    return r.trace.busy_s / r.traced.units * 1e3
