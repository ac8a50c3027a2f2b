"""Device ms a class-conditional call in the convolution category (the
VQVAE's decode of the generated images)."""
from cvbench import readers


def read(run):
    return readers.category_ms(run, "sample", ("convolution",))
