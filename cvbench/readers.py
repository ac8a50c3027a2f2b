"""What the metric readers (`metrics/<name>.py`) share. A reader takes the
run record that `run.py` builds and returns a number, or None where its
run holds nothing for it to read (the harness then leaves it out).

The run record: "kind" (sample | train), "config", "traffic", "setup_s";
with --trace 0 "window" (seconds, units, images, latencies) and
"peak_window_bytes"; with --trace 1 "traced": the profiled
`devtrace.Trace` and the kernel wrappers' "launches" over it.
"""
from __future__ import annotations

from typing import Optional, Sequence

from cvbench import counts


def traced(run, kind: str):
    return run.get("traced") if run["kind"] == kind else None


def launches(run, kind: str) -> Optional[float]:
    """Device operations a call or step in the profiled window."""
    t = traced(run, kind)
    return None if t is None else len(t["trace"].device_ops) / t["trace"].units


def category_ms(run, kind: str, cats: Sequence[str]) -> Optional[float]:
    """Device ms a call or step in the categories `cats`."""
    t = traced(run, kind)
    if t is None:
        return None
    by = t["trace"].by_category()
    return sum(by.get(c, 0.0) for c in cats) * 1e3 / t["trace"].units


def idle_share(run, kind: str) -> Optional[float]:
    """The profiled window's share, in %, in which no device operation ran."""
    t = traced(run, kind)
    if t is None:
        return None
    tr = t["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def mfu(run, kind: str, flops_per_unit: float) -> Optional[float]:
    """Model FLOPs of the profiled calls or steps over the device's busy
    time in them, in % of the bf16 dense peak."""
    t = traced(run, kind)
    if t is None:
        return None
    busy = t["trace"].busy_s()
    if busy <= 0.0:
        return None
    return 100.0 * flops_per_unit * t["trace"].units / busy / counts.PEAK_BF16_FLOPS


def roofline(run, kind: str, cat: str, kernel: str, bound_per_launch_s: float
             ) -> Optional[float]:
    """A kernel's share of its roofline, in %: its launches' bound over their
    device time in the profiled window. None where it did not run."""
    t = traced(run, kind)
    if t is None:
        return None
    n = t["launches"].get(kernel, 0)
    busy = sum(e - s for _, s, e in t["trace"].ops_in(cat)) / 1e6
    if n == 0 or busy <= 0.0:
        return None
    return 100.0 * n * bound_per_launch_s / busy
