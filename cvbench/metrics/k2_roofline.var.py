"""K2 (bisection sampling) over the profiled class-conditional calls: the
bound of its launches (`counts_var.k2_bound_s`, one a scale over batch x
pn^2 combined rows) over their device time, in %."""
from cvbench import counts_var, readers


def read(run):
    m, t = run["config"]["model"], run["traffic"]
    per_launch = counts_var.k2_bound_s(m, t["batch"]) / len(m["patch_nums"])
    return readers.roofline(run, "sample", "K2 sampling", "K2", per_launch)
