"""Model FLOPs a step (`counts.train_step_flops`) over the device's busy time
a step in the profiled steps, in % of the H100's bf16 dense peak."""
from cvbench import counts, readers


def read(run):
    m, v, t = run["config"]["model"], run["config"]["vqvae"], run["traffic"]
    return readers.mfu(run, "train", counts.train_step_flops(m, v, t["batch"]))
