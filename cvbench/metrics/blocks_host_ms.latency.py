"""Host ms a call inside the program's cv/blocks spans (the transformer
blocks of every scale: their dispatch, and any wait inside them), in the
cells whose end-to-end metric is a call's latency."""
from cvbench import spans


def read(run):
    return spans.host_ms(run, "sample", ("cv/blocks",))
