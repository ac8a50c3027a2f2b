"""K1 (decode attention) over the profiled calls: the bound of its launches
(`counts.k1_bound_s`, a call's depth x scales launches) over their device
time, in %."""
from cvbench import counts, readers


def read(run):
    m, t = run["config"]["model"], run["traffic"]
    per_launch = counts.k1_bound_s(m, 4 * t["batch"]) / (m["depth"] * len(m["patch_nums"]))
    return readers.roofline(run, "sample", "K1/K8 decode attention", "K1", per_launch)
