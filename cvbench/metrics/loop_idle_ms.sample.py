"""Device idle ms a call in the gaps between device operations that begin
inside one of the program's cv/scale/<si> spans: the device waiting on the
host's dispatch of the scale loop."""
from cvbench import spans


def read(run):
    split = spans.idle_split(run, "sample", ("cv/scale/",))
    return None if split is None else split[0]
