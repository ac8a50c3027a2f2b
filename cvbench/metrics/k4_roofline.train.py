"""K4 (flash attention backward, both passes) over the profiled steps: the
bound of its launches (`counts.k4_bound_s`) over their device time, in %."""
from cvbench import counts, readers


def read(run):
    m, t = run["config"]["model"], run["traffic"]
    return readers.roofline(run, "train", "K4 flash attention backward", "K4",
                            counts.k4_bound_s(m, t["batch"]))
