"""The benchmark's data, found by name.

`BENCHMARK.json` at the repository root lists the configurations, traffic
mixes, cells and metrics. Everything that belongs to one of them sits in a
file of its own under `cvbench/`, named after it:

  configs/<config>.json     the model configuration as it is run
  traffic/<traffic>.json    a traffic mix; its "driver" names drivers/<driver>.py
  limits/<workload>.json    the limits of the numbers that decide `correct`
  metrics/<metric>.py       the reader of one metric (`read(run)`)

A later cell or metric is added by adding files and entries; nothing here
changes for it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The module in the file at `path` (a metric's name may hold dots, so
    it is loaded by path, not imported by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with what it names, loaded."""

    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    def metrics(self, trace: bool) -> List[Dict]:
        """The metrics this cell reports: its per-layer ones with --trace 1,
        its end-to-end ones otherwise."""
        return self.per_layer if trace else self.end_to_end


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench_path: str = os.path.join(ROOT, "BENCHMARK.json")) -> Cell:
    """The cell named `workload`, with its configuration, traffic, limits and
    metrics; raises KeyError for a name BENCHMARK.json does not hold."""
    bench = load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    limits = load_json(os.path.join(HERE, "limits", workload + ".json"))
    return Cell(name=workload, chips=w["chips"], config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def driver(traffic: Dict):
    """The driver module that a traffic mix names."""
    name = traffic["driver"]
    return load_module(os.path.join(HERE, "drivers", name + ".py"), f"cvbench_driver_{name}")


def reader(metric_name: str):
    """The `read(run)` function of a metric."""
    path = os.path.join(HERE, "metrics", metric_name + ".py")
    return load_module(path, "cvbench_metric_" + metric_name.replace(".", "_")).read
