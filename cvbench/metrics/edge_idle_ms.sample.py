"""Device idle ms a call in the gaps that begin outside every cv/scale/<si>
span of the program (tokenize, prologue, decode, the caller's copy-out and
the next call's start) and in the window's stretches before the first
device operation and after the last. With `loop_idle_ms.sample` it adds up
to the window's idle ms a call."""
from cvbench import spans


def read(run):
    split = spans.idle_split(run, "sample", ("cv/scale/",))
    return None if split is None else split[1]
