"""Images completed in the window over its seconds."""


def read(run):
    w = run.get("window")
    return None if w is None or run["kind"] != "sample" else w["images"] / w["seconds"]
