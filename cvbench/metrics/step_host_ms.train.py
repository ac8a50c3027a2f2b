"""Host ms a step inside the program's cv/step span and outside its cv/wait
spans: the host's own work on a step. Set against `step_s`, it says whether
the host sets the pace."""
from cvbench import spans


def read(run):
    return spans.host_ms(run, "train", ("cv/step",), outside=("cv/wait",))
