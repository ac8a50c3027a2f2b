"""K3 (flash attention forward) over the profiled steps: the bound of its
launches (`counts.k3_bound_s`) over their device time, in %."""
from cvbench import counts, readers


def read(run):
    m, t = run["config"]["model"], run["traffic"]
    return readers.roofline(run, "train", "K3 flash attention", "K3",
                            counts.k3_bound_s(m, t["batch"]))
