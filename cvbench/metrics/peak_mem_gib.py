"""torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats(), in GiB."""


def read(run):
    if run.get("window") is None or run["kind"] != "train":
        return None
    return run["peak_window_bytes"] / 2 ** 30
