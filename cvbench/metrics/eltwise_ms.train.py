"""Device ms in the elementwise and copy-and-cast categories (the blocks'
LayerNorm, AdaLN and casts) a step."""
from cvbench import readers


def read(run):
    return readers.category_ms(run, "train", ("elementwise", "copy and cast"))
