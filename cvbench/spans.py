"""What the span metrics share: the program's own spans in the profiled
window, and host time and device idle time set against them.

The port opens a `torch.profiler.record_function` range named "cv/<name>"
at each layer boundary of a call or step (`controlvar_tpu_torch/utils/
tracker.py:span`), only while a profiler window is open. The ranges land
in `devtrace.Trace.host_ops` on the profiler's clock, beside the device's
operations. A trace without any "cv/" range (a program that opens none)
gives no reading: every function here returns None then.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

from cvbench import readers

PREFIX = "cv/"
Interval = Tuple[float, float]


def traced_spans(run, kind: str):
    """(trace, [(name, start us, end us)] of its "cv/" ranges), or None
    where the run holds no trace of `kind` or the trace no "cv/" range."""
    t = readers.traced(run, kind)
    if t is None:
        return None
    tr = t["trace"]
    spans = [op for op in tr.host_ops if op[0].startswith(PREFIX)]
    return (tr, spans) if spans else None


def union(spans, names: Sequence[str]) -> List[Interval]:
    """The union of the intervals of the spans whose name is one of
    `names`, or starts with one that ends in "/", as sorted disjoint
    (start, end) pairs."""
    picked = sorted((s, e) for name, s, e in spans
                    if any(name == n or (n.endswith("/") and name.startswith(n))
                           for n in names))
    out: List[Interval] = []
    for s, e in picked:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def length(intervals: List[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def overlap(a: List[Interval], b: List[Interval]) -> float:
    """The length of the intersection of two unions."""
    total, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += min(e, b[k][1]) - max(s, b[k][0])
            k += 1
    return total


def covers(intervals: List[Interval], t: float) -> bool:
    """Whether the instant t lies within one of the union's intervals."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


def host_ms(run, kind: str, inside: Sequence[str],
            outside: Sequence[str] = ()) -> Optional[float]:
    """Host ms a unit inside the spans named `inside` and not inside those
    named `outside`."""
    got = traced_spans(run, kind)
    if got is None:
        return None
    tr, spans = got
    a = union(spans, inside)
    us = length(a) - (overlap(a, union(spans, outside)) if outside else 0.0)
    return us / 1e3 / tr.units


def idle_split(run, kind: str, names: Sequence[str]) -> Optional[Tuple[float, float]]:
    """Device idle ms a unit (`Trace.idle_gaps`) in gaps that begin inside
    the spans named `names`, and in all others: the gaps that begin outside
    them, and the window's stretches before the first device operation and
    after the last. The two add up to the window's idle ms a unit, window_s
    less busy_s, as `readers.idle_share` counts it."""
    got = traced_spans(run, kind)
    if got is None:
        return None
    tr, spans = got
    within = union(spans, names)
    inside = outside = 0.0
    for s, e in tr.idle_gaps():
        if covers(within, s):
            inside += e - s
        else:
            outside += e - s
    if tr.device_ops:
        first = min(op[1] for op in tr.device_ops)
        last = max(op[2] for op in tr.device_ops)
        outside += tr.window_s * 1e6 - (last - first)
    else:
        outside += tr.window_s * 1e6
    return inside / 1e3 / tr.units, outside / 1e3 / tr.units
