"""Device ms in the elementwise and copy-and-cast categories (the blocks'
LayerNorm, AdaLN and casts) a call."""
from cvbench import readers


def read(run):
    return readers.category_ms(run, "sample", ("elementwise", "copy and cast"))
