"""K1 (decode attention) over the profiled class-conditional calls: the
bound of its launches (`counts_var.k1_bound_s` at 2 x batch CFG rows, a
call's depth x scales launches) over their device time, in %."""
from cvbench import counts_var, readers


def read(run):
    m, t = run["config"]["model"], run["traffic"]
    per_launch = counts_var.k1_bound_s(m, 2 * t["batch"]) / (m["depth"] * len(m["patch_nums"]))
    return readers.roofline(run, "sample", "K1/K8 decode attention", "K1", per_launch)
