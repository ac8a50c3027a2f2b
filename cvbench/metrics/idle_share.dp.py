"""The share of rank 0's profiled window, in %, in which its device ran
nothing."""
from cvbench import readers


def read(run):
    return readers.idle_share(run, "train")
