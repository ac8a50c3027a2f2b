"""The share of the profiled window, in %, in which the device ran nothing."""
from cvbench import readers


def read(run):
    return readers.idle_share(run, "train")
