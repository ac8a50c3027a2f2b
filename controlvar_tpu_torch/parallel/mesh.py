"""The device layout and the tensor-parallel sharding rules.

The port of `controlvar_tpu/parallel/mesh.py`. The port runs data parallel
over processes, one device each (`parallel/distributed.py`), so the layout
is a `MeshConfig` of `data` = the number of processes and `model` = 1;
a model axis above 1 (tensor parallelism) raises, as it needs more than one
card per model. The rule table of the JAX package's Megatron-style layout is
kept, with a PartitionSpec written as a tuple of axis names (None for a
replicated dimension), so that a tensor-parallel port finds it ready:
  qkv/fc1 kernels       column-parallel (shard output features)
  proj/fc2 kernels      row-parallel    (shard input features)
  head kernel           column-parallel (shard vocab)
  embeddings, norms     replicated
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from controlvar_tpu_torch.config import MeshConfig
from controlvar_tpu_torch.parallel.distributed import process_count

PSpec = Tuple[Optional[str], ...]


def make_mesh(data: Optional[int] = None, model: int = 1) -> MeshConfig:
    """The data-parallel layout over the processes of the group. model > 1
    raises: tensor parallelism waits for more than one card."""
    if model != 1:
        raise NotImplementedError(
            f"a model axis of {model}: tensor parallelism is not ported (one card per model)")
    n = process_count()
    if data is None:
        data = n
    if data != n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} processes, have {n}")
    return MeshConfig(data=data, model=model)


_BLOCK_RULES = {
    # leading axis is the depth stack; feature axes follow
    "qkv_kernel": (None, None, "model"),
    "q_bias": (None, "model"),
    "v_bias": (None, "model"),
    ("proj", "kernel"): (None, "model", None),
    ("proj", "bias"): (None, None),
    ("fc1", "kernel"): (None, None, "model"),
    ("fc1", "bias"): (None, "model"),
    ("fc2", "kernel"): (None, "model", None),
    ("fc2", "bias"): (None, None),
    ("ada_lin", "kernel"): (None, None, "model"),
    ("ada_lin", "bias"): (None, "model"),
    "scale_mul": (None, None),
    "ada_gss": (None, None, None),
}


def param_pspec(path_names: tuple, leaf=None) -> PSpec:
    """The PartitionSpec, as a tuple, of one model-param leaf by its path
    (dict keys and list indices from the root)."""
    if "blocks" in path_names:
        sub = path_names[path_names.index("blocks") + 1:]
        if sub in _BLOCK_RULES:
            return _BLOCK_RULES[sub]
        if len(sub) >= 2 and sub[-2:] in _BLOCK_RULES:
            return _BLOCK_RULES[sub[-2:]]
        if sub and sub[0] in _BLOCK_RULES:
            return _BLOCK_RULES[sub[0]]
        return ()
    if "head" in path_names and path_names[-1] == "kernel":
        return (None, "model")  # column-parallel vocab projection
    if "head" in path_names and path_names[-1] == "bias":
        return ("model",)
    return ()  # embeddings, norms, vqvae convs: replicated


def param_shardings(mesh: MeshConfig, params: Dict, path: tuple = ()):
    """A tree like `params` of PartitionSpec tuples; a spec whose axis does
    not divide its dimension falls back to replication."""
    if params is None:
        return None
    if isinstance(params, dict):
        return {k: param_shardings(mesh, v, path + (k,)) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [param_shardings(mesh, v, path + (i,)) for i, v in enumerate(params)]
    spec = param_pspec(path, params)
    sizes = {"data": mesh.data, "model": mesh.model}
    if any(axis is not None and params.shape[dim] % sizes[axis]
           for dim, axis in enumerate(spec)):
        return ()
    return spec
