"""The six readers of the program's spans (`cvbench/spans.py`,
`metrics/{blocks_host_ms.latency,loop_host_ms.latency,loop_idle_ms.sample,
edge_idle_ms.sample,wait_idle_ms.train,step_host_ms.train}.py`) on
profiled windows built by hand, against values worked out by hand; None on
a window without "cv/" spans, as the parent commit's program gives."""
import random

import pytest

from cvbench import spans, spec
from cvbench.devtrace import Trace

# two calls' worth of one call, in us: spans (some nested, one overlapping
# its neighbour), host operations of the program, device operations
CALL_SPANS = [("cv/call", 0, 500), ("cv/tokenize", 10, 50), ("cv/prologue", 50, 60),
              ("cv/scale/0", 60, 200), ("cv/blocks", 70, 150), ("cv/head", 150, 160),
              ("cv/draw", 160, 170), ("cv/canvas", 170, 200),
              ("cv/scale/1", 200, 400), ("cv/blocks", 210, 330), ("cv/blocks", 300, 340),
              ("cv/decode", 400, 480)]
HOST_OPS = [("aten::add", 75, 80), ("cudaLaunchKernel", 212, 214),
            ("cudaStreamSynchronize", 480, 495)]
CALL_DEVICE = [("k1", 20, 40), ("k2", 100, 180), ("k3", 190, 250), ("k4", 300, 420),
               ("k5", 450, 470)]
# gaps: (40, 100) from tokenize, (180, 190) in scale 0, (250, 300) in scale 1,
# (420, 450) from decode; busy 300 of a 1000 us window, first 20, last 470

STEP_SPANS = [("cv/step", 0, 800), ("cv/tokenize", 10, 60), ("cv/forward", 60, 400),
              ("cv/wait", 100, 150), ("cv/wait", 105, 140), ("cv/wait", 300, 320),
              ("cv/backward", 400, 700), ("cv/update", 700, 800)]
STEP_DEVICE = [("k", 0, 120), ("k", 160, 310), ("k", 330, 900)]
# gaps: (120, 160) begins in the first wait, (310, 330) in the last


def _run(kind, host, device, window_s=1e-3, units=2):
    return {"kind": kind, "traced": {"trace": Trace(device, host, window_s, units),
                                     "launches": {}}}


def _read(name, run):
    return spec.reader(name)(run)


def test_call_readers_by_hand():
    run = _run("sample", CALL_SPANS + HOST_OPS, CALL_DEVICE)
    # cv/blocks: (70, 150) and (210, 340), 80 + 130 us over 2 calls
    assert _read("blocks_host_ms.latency", run) == pytest.approx(0.105)
    # cv/scale/*: (60, 400), 340 us, less the blocks' 210
    assert _read("loop_host_ms.latency", run) == pytest.approx(0.065)
    assert _read("loop_idle_ms.sample", run) == pytest.approx((10 + 50) / 2e3)
    # the gaps from tokenize (60) and decode (30), and the window's 1000 - 450 us
    assert _read("edge_idle_ms.sample", run) == pytest.approx((60 + 30 + 550) / 2e3)


def test_step_readers_by_hand():
    run = _run("train", STEP_SPANS + HOST_OPS, STEP_DEVICE)
    assert _read("wait_idle_ms.train", run) == pytest.approx((40 + 20) / 2e3)
    # 800 us of step less the waits' union, (100, 150) and (300, 320)
    assert _read("step_host_ms.train", run) == pytest.approx((800 - 50 - 20) / 2e3)


@pytest.mark.parametrize("name,kind", [
    ("blocks_host_ms.latency", "sample"), ("loop_host_ms.latency", "sample"),
    ("loop_idle_ms.sample", "sample"), ("edge_idle_ms.sample", "sample"),
    ("wait_idle_ms.train", "train"), ("step_host_ms.train", "train")])
def test_no_reading_without_the_programs_spans(name, kind):
    host, device = (CALL_SPANS, CALL_DEVICE) if kind == "sample" else (STEP_SPANS, STEP_DEVICE)
    unnamed = [(n.replace("cv/", "program::"), s, e) for n, s, e in host] + HOST_OPS
    assert _read(name, _run(kind, host + HOST_OPS, device)) is not None
    assert _read(name, _run(kind, unnamed, device)) is None
    other = "train" if kind == "sample" else "sample"
    assert _read(name, dict(_run(kind, host, device), kind=other)) is None
    assert _read(name, {"kind": kind, "window": {}}) is None


def test_loop_and_edge_idle_add_up_to_the_windows_idle():
    rng = random.Random(7)
    for trial in range(20):
        units, window_s = rng.randint(1, 5), rng.uniform(2e-3, 5e-3)
        device, t = [], rng.uniform(0, 100)
        while t < window_s * 1e6 - 200:
            d = rng.uniform(1, 60)
            device.append(("k", t, t + d))
            t += d * rng.uniform(0.3, 1.6)
        host, t = [], 0.0
        while t < window_s * 1e6:
            d = rng.uniform(5, 300)
            host.append((f"cv/scale/{trial}" if rng.random() < 0.6 else "cv/decode", t, t + d))
            t += d + rng.uniform(0, 50)
        run = _run("sample", host, device, window_s, units)
        tr = run["traced"]["trace"]
        idle_ms = (tr.window_s - tr.busy_s()) * 1e3 / units
        loop = _read("loop_idle_ms.sample", run)
        edge = _read("edge_idle_ms.sample", run)
        assert loop >= 0 and edge >= 0
        assert loop + edge == pytest.approx(idle_ms, rel=1e-9)


def test_union_and_overlap():
    u = spans.union([("cv/a", 5, 9), ("cv/a", 0, 2), ("cv/a", 1, 3), ("cv/b", 2, 8),
                     ("cv/scale/1", 20, 30), ("cv/scale/12", 25, 40)], ("cv/a", "cv/scale/"))
    assert u == [(0, 3), (5, 9), (20, 40)]
    assert spans.length(u) == 27
    assert spans.overlap(u, [(2, 6), (8, 25)]) == 1 + 1 + 1 + 5
    assert spans.covers(u, 20) and spans.covers(u, 3) and not spans.covers(u, 4)
