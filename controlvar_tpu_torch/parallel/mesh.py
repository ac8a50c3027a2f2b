"""The device layout and the tensor-parallel sharding rules.

The port of `controlvar_tpu/parallel/mesh.py`. One process drives one
device (`parallel/distributed.py`), so the JAX package's 2-D device mesh
('data', 'model') is a 2-D layout of the processes: `make_mesh(data, model)`
needs data x model of them, and rank r has data index r // model and model
index r % model, the order of the JAX package's `reshape(data, model)` of
its devices. The `Mesh` it returns holds two `torch.distributed`
subgroups: the model group (the ranks of one data index, which hold the
shards of one model and see the same batch rows) and the data group (the
ranks of one model index, over which gradients are averaged). With model =
1 there are no subgroups: the data group is the whole world, as under plain
data parallelism.

The rule table of the JAX package's Megatron-style layout is kept, with a
PartitionSpec written as a tuple of axis names (None for a replicated
dimension):
  qkv/fc1 kernels       column-parallel (shard output features)
  proj/fc2 kernels      row-parallel    (shard input features)
  head kernel           column-parallel (shard vocab)
  embeddings, norms     replicated
`parallel/tensor.py` cuts a parameter tree by it (whole heads for the
attention leaves) and holds the collectives of the sharded blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch.distributed as dist

from controlvar_tpu_torch.config import MeshConfig
from controlvar_tpu_torch.parallel.distributed import process_count, process_index

PSpec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh(MeshConfig):
    """A `MeshConfig` (equal to the one of the same data and model sizes)
    with this process's place on it and its two subgroups. A group of None
    is the whole world (model = 1) or no group at all (one process)."""

    data_index: int = 0
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None

    def __eq__(self, other):
        if not isinstance(other, MeshConfig):
            return NotImplemented
        return (self.data, self.model) == (other.data, other.model)

    def __hash__(self):
        return hash((self.data, self.model))

    @property
    def model_root(self) -> int:
        """The global rank of model index 0 of this process's model group."""
        return self.data_index * self.model


def check_model_axis(cfg, model: int) -> None:
    """A model axis must divide the AdaLN width 6C and the MLP's hidden
    width, which are always split; the heads and the vocabulary fall back
    to replication where it does not divide them."""
    hidden = round(cfg.embed_dim * cfg.mlp_ratio)
    if (6 * cfg.embed_dim) % model or hidden % model:
        raise ValueError(f"a model axis of {model} must divide 6C = {6 * cfg.embed_dim} and "
                         f"the MLP width {hidden}")


def data_shard(model: int = 1) -> Tuple[int, int]:
    """(shard_id, num_shards) of this process's loader on a mesh with this
    model axis: its data index over the data axis, without making the mesh
    (the ranks of one model group read the same rows)."""
    return process_index() // model, max(1, process_count() // model)


def make_mesh(data: Optional[int] = None, model: int = 1, cfg=None) -> Mesh:
    """The layout of the process group as data x model. data defaults to
    the process count over model; data x model must be the process count.
    With cfg, the model axis is checked against its widths
    (`check_model_axis`). Every rank must call it, in the same order, as it
    makes the subgroups."""
    n = process_count()
    if model < 1:
        raise ValueError(f"a model axis of {model}")
    if data is None:
        data = max(1, n // model)
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} processes, have {n}")
    if cfg is not None:
        check_model_axis(cfg, model)
    rank = process_index()
    data_group = model_group = None
    if model > 1:
        for d in range(data):
            g = dist.new_group([d * model + j for j in range(model)])
            if d == rank // model:
                model_group = g
        for j in range(model):
            g = dist.new_group([d * model + j for d in range(data)])
            if j == rank % model:
                data_group = g
    return Mesh(data=data, model=model, data_index=rank // model, model_index=rank % model,
                data_group=data_group, model_group=model_group)


def tp_of(mesh) -> Optional[Mesh]:
    """The mesh when it splits the model (model > 1), else None: the
    argument the block functions take."""
    return mesh if mesh is not None and mesh.model > 1 else None


def replicated(mesh: MeshConfig) -> PSpec:
    """The spec of a tensor that every rank holds whole."""
    return ()


def batch_sharding(mesh: MeshConfig) -> PSpec:
    """The spec of a batch: rows split over the data axis (each data index
    reads its loader shard), whole along the model axis."""
    return ("data",)


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
