"""The 95th percentile of the latency of every call in the window, from its
start until its image is on the host."""
import statistics


def read(run):
    w = run.get("window")
    if w is None or run["kind"] != "sample" or len(w["latencies"]) < 2:
        return None
    return statistics.quantiles(w["latencies"], n=20)[18]
