"""Share of the bandwidth roofline of K1's pooled form (`gather_pool_rows`,
a multi-hot model's bag read) over the traced stretch: the bytes its
launches need (the driver's `kernel_work()["k1_bag"]`) over its device
time, the trace's operations whose name holds `gather_pool_rows`. A
program without the kernel reads None."""

import re

from portbench import roofline

NAME = re.compile(r"\bgather_pool_rows\b")


def read(r):
    if r.trace is None:
        return None
    seconds = sum(s for name, s in r.trace.by_name.items()
                  if NAME.search(name))
    return roofline.share(r.work.get("k1_bag", 0), seconds)
