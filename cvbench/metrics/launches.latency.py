"""Device operations a call in the profiled window, in the cells whose
end-to-end metric is a call's latency."""
from cvbench import readers


def read(run):
    return readers.launches(run, "sample")
