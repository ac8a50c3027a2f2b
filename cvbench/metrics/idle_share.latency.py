"""The share of the profiled window, in %, in which the device ran nothing,
in the cells whose end-to-end metric is a call's latency."""
from cvbench import readers


def read(run):
    return readers.idle_share(run, "sample")
