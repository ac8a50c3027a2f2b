"""Device idle ms a step in the gaps between device operations that begin
inside one of the program's cv/wait spans: the device idle because the
host blocked on it (the host-drawn drop masks' blocking copies)."""
from cvbench import spans


def read(run):
    split = spans.idle_split(run, "train", ("cv/wait",))
    return None if split is None else split[0]
