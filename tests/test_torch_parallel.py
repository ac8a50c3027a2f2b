"""The port's data parallelism (`parallel/`) and `config.MeshConfig`.

Two gloo processes, run as subprocesses the way tests/test_multiprocess.py
runs its workers (tests/torch_parallel_worker.py), each take one fp32
`Trainer` step on their half of a global batch of 4 (Loader shard_id /
num_shards) whose ignore masks weigh the two halves differently; a third
process takes the step on the whole batch. The ranks' params must be equal
bit for bit (one all-reduce of the gradients), and equal to the
one-process step within 2e-6 absolute at lr 1e-2 (the gradient sums run in
another order, ~1e-7 relative, and AdamW's first step moves each param by
about lr); the logged loss is the global batch's ignore-weighted mean
(1e-6 relative), which a mean of the ranks' own means would miss. The
tensor-parallel rule table must give the JAX package's PartitionSpec for
every leaf of a d16 tree."""
import json
import os
import sys

import numpy as np
import pytest

import jax

from controlvar_tpu.config import MeshConfig as JMeshConfig
from controlvar_tpu.config import control_var_config_from_depth as j_cfg_from_depth
from controlvar_tpu.models.control_var import ControlVARModel as JModel
from controlvar_tpu.parallel import mesh as jmesh

import torch

from controlvar_tpu_torch.config import MeshConfig
from controlvar_tpu_torch.parallel import distributed, mesh
from tests.torch_world import World

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [per-rank npz, json]} of the two-process and one-process runs,
    all three processes started together."""
    out = tmp_path_factory.mktemp("dp")
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")}
    env["OMP_NUM_THREADS"] = "2"
    World(lambda ports: [[sys.executable, WORKER, str(r), str(w), ports[0], str(out)]
                         for w, r in ((2, 0), (2, 1), (1, 0))], env=env).wait(300)

    def load(r, w):
        with open(out / f"rank{r}_of{w}.json") as f:
            return dict(np.load(out / f"rank{r}_of{w}.npz")), json.load(f)

    return {2: [load(0, 2), load(1, 2)], 1: [load(0, 1)]}


def _params(arrays):
    return {k: v for k, v in arrays.items() if k.startswith("param/")}


def test_ranks_end_with_equal_params_bit_for_bit(runs):
    (a, ja), (b, jb) = runs[2]
    pa, pb = _params(a), _params(b)
    assert sorted(pa) == sorted(pb) and len(pa) > 10
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    assert ja["step"] == jb["step"] == 1
    assert len(ja["logs"]) == 1 and jb["logs"] == []  # only the primary logs


def test_two_process_step_equals_the_one_process_step(runs):
    (a, ja), (b, _) = runs[2]
    (one, jone), = runs[1]
    p2, p1 = _params(a), _params(one)
    assert sorted(p2) == sorted(p1)
    for k in p1:
        np.testing.assert_allclose(p2[k], p1[k], rtol=0, atol=2e-6, err_msg=k)
    two, single = ja["logs"][0], jone["logs"][0]
    np.testing.assert_allclose(two["loss"], single["loss"], rtol=1e-6)
    np.testing.assert_allclose(two["grad_norm"], single["grad_norm"], rtol=1e-5)
    # the halves carry different ignore weights, so the global mean is not
    # the mean of the two halves' means
    wa, wb = float(a["weight"]), float(b["weight"])
    assert wa != wb and wa + wb == float(one["weight"])


def test_mesh_config_equals_the_jax_one():
    assert MeshConfig() == MeshConfig(1, 1) and MeshConfig(2, 3).num_devices == 6
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(MeshConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(JMeshConfig)]


@pytest.mark.parametrize("layout", ["default", "model=2", "data=2"])
def test_make_mesh_is_data_parallel_over_the_processes(layout):
    """One process: the default layout is 1x1, and a layout of two
    processes (a model axis of 2, tensor parallel, or a data
    axis of 2) raises, naming the processes it needs."""
    if layout == "default":
        assert mesh.make_mesh() == MeshConfig(data=1, model=1)
        return
    with pytest.raises(ValueError, match="needs 2 processes"):
        mesh.make_mesh(**{layout.split("=")[0]: 2})


def test_distributed_helpers_without_a_group():
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    assert distributed.is_primary() and distributed.local_device_count() >= 1
    distributed.initialize(device="cpu")  # nothing in the environment: a no-op
    assert not torch.distributed.is_initialized()
    t = torch.arange(3.0)
    assert distributed.all_reduce_sum(t) is t
    p = torch.ones(2, requires_grad=True)
    p.grad = torch.full((2,), 3.0)
    distributed.average_gradients([p])
    assert p.grad.tolist() == [3.0, 3.0]
    batch = distributed.form_global_batch("cpu", {"a": np.ones(2), "b": [np.zeros(1)]})
    assert batch["a"].dtype == torch.float64 and batch["b"][0].shape == (1,)
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(coordinator_address="localhost:1", device="cpu")


def _jax_paths_and_specs(depth):
    """(path names, PartitionSpec tuple) of every leaf of a JAX ControlVAR
    tree of this depth, from its shapes alone (no init)."""
    model = JModel(j_cfg_from_depth(depth, multi_cond=True, separator=True, type_pos=True))
    shapes = jax.eval_shape(model.init_params, jax.random.key(0))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return [(jmesh._path_names(path), leaf, tuple(jmesh.param_pspec(jmesh._path_names(path),
                                                                    leaf)))
            for path, leaf in flat]


def test_param_pspec_equals_the_jax_rule_for_every_d16_leaf():
    leaves = _jax_paths_and_specs(16)
    assert len(leaves) > 20
    for names, leaf, want in leaves:
        assert mesh.param_pspec(names, leaf) == want, names
    assert {want for _, _, want in leaves} >= {(None, None, "model"), (None, "model", None),
                                               (None, "model"), ("model",), ()}


def test_param_shardings_divisibility_fallback():
    """A spec whose axis does not divide its dimension is replicated, as the
    JAX param_shardings falls back."""
    tree = {"blocks": {"qkv_kernel": torch.zeros(2, 4, 6), "q_bias": torch.zeros(2, 5)},
            "head": {"kernel": torch.zeros(4, 6), "bias": torch.zeros(6)},
            "norms": [None, torch.zeros(3)]}
    got = mesh.param_shardings(MeshConfig(data=1, model=2), tree)
    assert got == {"blocks": {"qkv_kernel": (None, None, "model"), "q_bias": ()},
                   "head": {"kernel": (None, "model"), "bias": ("model",)},
                   "norms": [None, ()]}
