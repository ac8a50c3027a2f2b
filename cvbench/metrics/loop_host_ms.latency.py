"""Host ms a call inside the program's cv/scale/<si> spans and outside
their cv/blocks: the sampler loop's own code (head, draw, canvas update and
next input), in the cells whose end-to-end metric is a call's latency."""
from cvbench import spans


def read(run):
    return spans.host_ms(run, "sample", ("cv/scale/",), outside=("cv/blocks",))
