"""Device idle ms a step, on rank 0, in the gaps between device operations
that begin inside the program's cv/allreduce span."""
from cvbench import spans


def read(run):
    split = spans.idle_split(run, "train", ("cv/allreduce",))
    return None if split is None else split[0]
