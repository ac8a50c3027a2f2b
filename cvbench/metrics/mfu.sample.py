"""Model FLOPs a call (`counts.cond_call_flops`) over the device's busy time
a call in the profiled calls, in % of the H100's bf16 dense peak."""
from cvbench import counts, readers


def read(run):
    m, v, t = run["config"]["model"], run["config"]["vqvae"], run["traffic"]
    return readers.mfu(run, "sample", counts.cond_call_flops(m, v, t["batch"]))
