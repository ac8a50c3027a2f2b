"""Model FLOPs a class-conditional call (`counts_var.var_call_flops`) over
the device's busy time a call in the profiled calls, in % of the H100's
bf16 dense peak."""
from cvbench import counts_var, readers


def read(run):
    m, v, t = run["config"]["model"], run["config"]["vqvae"], run["traffic"]
    return readers.mfu(run, "sample", counts_var.var_call_flops(m, v, t["batch"]))
