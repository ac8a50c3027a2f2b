"""What a run may load: nothing under cvbench/reference/ imports the
program, the JAX package or JAX; a CPU dry run of each cell leaves no
module whose top-level name is jax, jaxlib, flax or controlvar_tpu
(compared whole: controlvar_tpu_torch is the program)."""
import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from cvbench import spec

REFERENCE_MAY_IMPORT = {"torch", "numpy", "math", "contextlib", "typing", "__future__",
                        "cvbench"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(spec.HERE, "reference", "*.py"))))
def test_reference_imports_nothing_of_the_program(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top in REFERENCE_MAY_IMPORT, (path, name)
        assert not name.startswith("cvbench.") or name.startswith("cvbench.reference"), name


DRY_RUN = """
import json, sys, torch
torch.set_num_threads(2)
from cvbench import run
from cvbench.tests.tiny import tiny_cell
result, _, _ = run.run_cell(tiny_cell(sys.argv[1]), 5, 1.5, False, "cpu")
print(json.dumps([result["correct"], run.forbidden_modules()]))
"""


@pytest.mark.parametrize("workload", [w["name"] for w in spec.load_json(
    os.path.join(spec.ROOT, "BENCHMARK.json"))["workloads"]])
def test_dry_run_loads_no_jax(workload):
    env = dict(os.environ, PYTHONPATH=spec.ROOT)
    out = subprocess.run([sys.executable, "-c", DRY_RUN, workload], capture_output=True,
                         text=True, cwd=spec.ROOT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ok, forbidden = json.loads(out.stdout.strip().splitlines()[-1])
    assert ok and forbidden == []
