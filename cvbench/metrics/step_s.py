"""The window's seconds over the steps completed in it."""


def read(run):
    w = run.get("window")
    return None if w is None or run["kind"] != "train" else w["seconds"] / w["units"]
