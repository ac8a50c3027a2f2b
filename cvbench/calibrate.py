"""The readings that the limits of `correct` are set from (never run by a
benchmark run).

    python3 cvbench/calibrate.py --workload d16_cond_b16 --seeds 1,2,3 \
        --control-seeds 4,5,6 --fault-seeds 7,8,9 --seconds 3

For each of --seeds, a sound run of the program at the cell's own size:
set-up, a short window at the cell's load (long enough for its greedy and
sampled calls; a training cell's readings need none), the check's numbers.
For each of --control-seeds, the control: the reference in fp8 in the
program's place. For each of --fault-seeds, a run of the program with each
fault of `cvbench/faults.py` that the cell can have planted in it.

Each reading is judged against the cell's limits (`cvbench/limits/`) as a
run judges it. One JSON line per reading goes to standard output and to
chiprun_out/calibrate_<workload>.jsonl. The exit code is 1 when a sound
run comes out not correct, or the control or a fault comes out correct.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = ROOT


def reading(cell, seed: int, seconds: float, control: bool = False, fault=None):
    """The check's numbers of one run at the cell's size: the program's, or
    the control's, or the program's with `fault` planted."""
    import contextlib

    import torch

    from cvbench import spec

    drv = spec.driver(cell.traffic).Driver(cell.config, cell.traffic, seed, "cuda")
    with fault() if fault else contextlib.nullcontext():
        drv.setup()
        if drv.kind == "sample":
            drv.window(seconds)
    drv.release()
    numbers = drv.check(control=control)
    del drv
    torch.cuda.empty_cache()
    return numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    from cvbench import faults, judge, spec

    cell = spec.load_cell(args.workload)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    kind = spec.driver(cell.traffic).Driver.kind
    runs = [(int(s), "program", None) for s in args.seeds.split(",") if s]
    runs += [(int(s), "control fp8", None) for s in args.control_seeds.split(",") if s]
    runs += [(int(s), f"fault {name}", fn) for s in args.fault_seeds.split(",") if s
             for name, fn in faults.FAULTS[kind].items()]
    wrong = 0
    with open(os.path.join(out_dir, f"calibrate_{args.workload}.jsonl"), "a") as log:
        for seed, what, fault in runs:
            t = time.time()
            numbers = reading(cell, seed, args.seconds, what.startswith("control"), fault)
            within = judge.all_within(judge.verdict(numbers, cell.limits))
            wrong += within != (what == "program")
            line = json.dumps(dict(workload=args.workload, seed=seed, reading=what,
                                   correct=within, numbers=numbers, seconds=time.time() - t))
            print(line, flush=True)
            log.write(line + "\n")
    print(f"calibrate {args.workload}: {len(runs)} readings, {wrong} judged wrongly",
          file=sys.stderr)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
