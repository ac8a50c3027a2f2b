"""Set-up seconds: process start to the first timed call (`run.py`)."""


def read(run):
    return run["setup_s"]
