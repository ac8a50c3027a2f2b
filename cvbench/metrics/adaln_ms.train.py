"""Device ms a step in the blocks' AdaLN kernels (operations whose names
contain `adaln_`: the three sites' forward kernels, their backward kernels
and the backward's column sums); None where none ran."""
from cvbench import readers


def read(run):
    t = readers.traced(run, "train")
    if t is None:
        return None
    tr = t["trace"]
    spans = [e - s for name, s, e in tr.device_ops if "adaln_" in name]
    return sum(spans) / 1e3 / tr.units if spans else None
