"""The share of the profiled class-conditional window, in %, in which the
device ran nothing."""
from cvbench import readers


def read(run):
    return readers.idle_share(run, "sample")
