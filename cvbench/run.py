"""Run one cell of the benchmark and print its result line.

    python3 cvbench/run.py --workload d16_cond_b16 --seed 2147483659 --seconds 51 --trace 0

The cell (`BENCHMARK.json` "workloads") names a configuration
(`cvbench/configs/`) and a traffic mix (`cvbench/traffic/`), whose
"driver" (`cvbench/drivers/`) makes the weights and inputs on the card
from the seed, builds the program (`controlvar_tpu_torch`) and warms every
shape of the cell (set-up), then runs it for --seconds (--trace 0: the
end-to-end metrics) or profiles a few calls or steps (--trace 1: the
per-layer metrics). Once the window has closed, the program's state is
freed and what the timed path produced is held against the plain
reference (`cvbench/judge.py`); each number compared is printed with its
limit (`cvbench/limits/<workload>.json`), last on standard error and last
in the result, the JSON object printed as the last line of standard output.

Exits non-zero without a result when there is no CUDA device (or fewer
than the cell asks for), when the program is missing, and when the JAX
package, jax, jaxlib or flax is loaded in the process.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_T_FIRST_LINE = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = ROOT      # import the harness as the package `cvbench`
FORBIDDEN = ("jax", "jaxlib", "flax", "controlvar_tpu")


def process_start() -> float:
    """The wall time at which this process started (Linux), else the time
    this module began to run."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _T_FIRST_LINE


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or ""."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else ""


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             started: float = None):
    """Set-up, the window (or the profiled calls), then the check. Returns
    the result object without "device" (the caller adds it) and the
    checks."""
    import torch

    from cvbench import judge, spec

    started = _T_FIRST_LINE if started is None else started
    drv = spec.driver(cell.traffic).Driver(cell.config, cell.traffic, seed, device)
    drv.setup()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run = dict(kind=drv.kind, config=cell.config, traffic=cell.traffic,
               setup_s=time.time() - started)
    if trace:
        run["traced"] = drv.traced(cell.traffic["trace_units"])
        attempted = cell.traffic["trace_units"]
    else:
        run["window"] = drv.window(seconds)
        attempted = run["window"]["units"]
    run["peak_window_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    drv.release()
    checks = judge.verdict(drv.check(), cell.limits)
    correct = judge.all_within(checks)
    metrics = {}
    for m in cell.metrics(trace):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    t = cell.traffic
    checked = t.get("check_images", 0) + t.get("check_sampled", 0) + t.get("checked_steps", 0)
    result = {"correct": correct, "attempted": attempted,
              "failed": 0 if correct else checked, "metrics": metrics}
    if trace:
        tr = run["traced"]["trace"]
        result["trace"] = dict(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    return result, run, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    started = process_start()
    # every cache of the run inside the checkout, at a fixed path
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    import torch

    from cvbench import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"cvbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result, run, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                                   started)
    bad = forbidden_modules()
    if bad:
        print(f"cvbench: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": run["peak_window_bytes"], "power": power_limit()}
    gaps = sorted(run.get("window", {}).get("gaps", []))
    if gaps:
        print(f"cvbench window: {len(gaps)} steps, host seconds between step returns: "
              f"median {gaps[len(gaps) // 2]!r}, longest {gaps[-5:][::-1]!r}",
              file=sys.stderr)
    for name, c in checks.items():
        print(f"cvbench check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result_line(result, device, checks)))
    return 0


def result_line(result, device, checks):
    """The result object in the contract's order: the checks, each number
    compared with its limit, last."""
    line = {k: result[k] for k in ("correct", "attempted", "failed", "metrics")}
    line["device"] = dict(device, **result.get("trace", {}))
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = checks
    return line


if __name__ == "__main__":
    sys.exit(main())
