"""Device operations a class-conditional call in the profiled window."""
from cvbench import readers


def read(run):
    return readers.launches(run, "sample")
