"""Device ms a call in the convolution category (the tokenizer: encoding
the control images, decoding the generated ones)."""
from cvbench import readers


def read(run):
    return readers.category_ms(run, "sample", ("convolution",))
