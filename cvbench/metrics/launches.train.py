"""Device operations a step in the profiled window."""
from cvbench import readers


def read(run):
    return readers.launches(run, "train")
