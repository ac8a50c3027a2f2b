"""The harness finds every cell, configuration, traffic mix, limit and
metric by name, and a run prints the contract's last line."""
import json
import os
import subprocess
import sys

import pytest
import torch

from cvbench import run, spec
from cvbench.tests.tiny import tiny_cell

BENCH = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cells_found_by_name(workload):
    cell = spec.load_cell(workload)
    assert cell.config["name"] == next(w["config"] for w in BENCH["workloads"]
                                       if w["name"] == workload)
    assert callable(spec.driver(cell.traffic).Driver)
    if cell.traffic["driver"] == "cond_sample":
        assert {"tok_gap", "logit_mean", "decode_rms", "draw_outside"} <= set(cell.limits)
        assert set(cell.limits) <= {"tok_gap", "logit_gap", "logit_mean", "decode_rms",
                                    "draw_outside"}
    else:
        assert set(cell.limits) == {"tok_gap", "loss_rel", "grad_gap", "change_gap"}
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))


def test_every_file_named_in_benchmark():
    for c in BENCH["configs"]:
        assert spec.load_json(os.path.join(spec.ROOT, c["file"]))["name"] == c["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.exists(os.path.join(spec.HERE, "metrics", m["name"] + ".py"))
    with pytest.raises(KeyError):
        spec.load_cell("no_such_cell")


def test_forbidden_modules_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "controlvar_tpu_torch_probe", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "controlvar_tpu.config", object())
    assert run.forbidden_modules() == ["controlvar_tpu"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, os.path.join(spec.HERE, "run.py"), "--workload",
                          "d16_cond_b16", "--seed", "3", "--seconds", "1"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("workload,trace", [("d16_cond_b16", False), ("d30_train_b8", True)])
def test_result_line(workload, trace):
    torch.set_num_threads(2)
    cell = tiny_cell(workload)
    result, _, checks = run.run_cell(cell, 2 ** 31 + 12345, 1.5, trace, "cpu")
    device = {"platform": "gpu", "kind": "test", "count": 1, "memory_peak_bytes": 0}
    line = json.loads(json.dumps(run.result_line(result, device, checks)))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and line["correct"] is True
    assert set(line["checks"]) == set(cell.limits)
    want = {m["name"] for m in cell.metrics(trace)}
    assert set(line["metrics"]) <= want
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == want
