"""The profiled window: device operations from `torch.profiler`, the device's
busy time as the union of their spans, time by category, and the breakdown
line (the longest device operations, the longest idle gaps by what the host
was doing).

`CATEGORIES` and the busy-time union are copied from `chip_smoke.py`
(`CATEGORIES`, `category`, `device_profile`), which has read every profiled
phase of the port with them since PR 8.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable, Dict, List, Tuple

# kernel-name substrings of each device-time category, tested in this order:
# K5 runs K1's kernel body under its own name, matched before K1/K8's
CATEGORIES = (("K5 prefix decode", ("decode_attention_prefix_kernel",)),
              ("K1/K8 decode attention", ("decode_attention_kernel",)),
              ("K7 flat decode attention", ("decode_flat_kernel",)),
              ("K6 in-place decode", ("decode_inplace_kernel",)),
              ("K2 sampling", ("sample_bisect_kernel",)),
              ("K3 flash attention", ("flash_fwd_kernel",)),
              ("K4 flash attention backward", ("flash_bwd_",)),
              ("convolution", ("fprop", "dgrad", "wgrad", "conv", "cudnn", "nchwToNhwc",
                               "nhwcToNchw")),
              ("matmul", ("gemm", "nvjet", "cutlass", "xmma")),
              ("copy and cast", ("copy", "Memcpy", "Memset")),
              ("elementwise", ("elementwise",)),
              ("reduction and norm", ("reduce", "Moments", "norm", "softmax")))


NAME_CHARS = 160    # a kernel's name in the breakdown, cut inside its template arguments


def category(name: str) -> str:
    """The device-time category of an operation's name, else "other"."""
    return next((c for c, keys in CATEGORIES if any(k in name for k in keys)), "other")


@dataclasses.dataclass
class Trace:
    """A profiled window: device operations (name, start us, end us), host
    operations (name, start us, end us), its host-clock length and the
    number of calls or steps it held."""

    device_ops: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]]
    window_s: float
    units: int

    def busy_s(self) -> float:
        """The union of the device operations' spans."""
        busy, end = 0.0, float("-inf")
        for _, s, e in sorted(self.device_ops, key=lambda op: op[1]):
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy / 1e6

    def by_category(self) -> Dict[str, float]:
        """Device seconds by category."""
        out: Dict[str, float] = {}
        for name, s, e in self.device_ops:
            c = category(name)
            out[c] = out.get(c, 0.0) + (e - s) / 1e6
        return out

    def ops_in(self, cat: str) -> List[Tuple[str, float, float]]:
        return [op for op in self.device_ops if category(op[0]) == cat]

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """(start us, end us) of every stretch between device operations."""
        gaps, end = [], None
        for _, s, e in sorted(self.device_ops, key=lambda op: op[1]):
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        return gaps

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost host operation running as each began,
        in seconds summed by name."""
        ops: Dict[str, float] = {}
        for name, s, e in self.device_ops:
            name = name[:NAME_CHARS]
            ops[name] = ops.get(name, 0.0) + (e - s) / 1e6
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[: 20 * top]
        host = sorted(self.host_ops, key=lambda op: op[1])
        starts = [op[1] for op in host]
        named: Dict[str, float] = {}
        for s, e in gaps:
            # the latest-started host operation still running at s
            i = bisect.bisect_right(starts, s) - 1
            while i >= 0 and host[i][2] <= s:
                i -= 1
            name = host[i][0] if i >= 0 else "(no host operation)"
            named[name] = named.get(name, 0.0) + (e - s) / 1e6
        rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(ops), "idle_gaps": rank(named)}


def profile(torch, fn: Callable[[], int]) -> Trace:
    """Run fn (which returns the calls or steps it made, each ended on the
    host) under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with tprofile(activities=acts) as prof:
        sync()
        t = time.perf_counter()
        units = fn()
        sync()
        window = time.perf_counter() - t
    dev, host = [], []
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            # record_function ranges shown on the device's timeline are no operations
            if e.name != "Command Buffer Full" and not getattr(e, "is_user_annotation", False):
                dev.append(span)
        else:
            host.append(span)
    return Trace(dev, host, window, units)
