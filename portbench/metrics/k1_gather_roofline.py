"""Share of the bandwidth roofline of the port's K1 over the traced
stretch: the bytes its launches need (`roofline.k1_bytes`, from what the
workload handed over) over its device time by kernel name in the trace."""

from portbench import roofline


def read(r):
    if r.trace is None:
        return None
    return roofline.share(r.work.get("k1", 0), r.trace.kernel_s("k1"))
