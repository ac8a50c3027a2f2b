"""Device ms a step, on rank 0, in operations whose names contain `nccl`
(the gradients' all-reduce, and the step signal's one-int broadcast); a
collective's kernel also holds its wait for the slowest rank."""
from cvbench import readers


def read(run):
    t = readers.traced(run, "train")
    if t is None:
        return None
    tr = t["trace"]
    spans = [e - s for name, s, e in tr.device_ops if "nccl" in name.lower()]
    return sum(spans) / 1e3 / tr.units if spans else None
