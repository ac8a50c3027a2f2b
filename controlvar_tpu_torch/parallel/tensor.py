"""Tensor parallelism over the mesh's `model` axis (Megatron-style).

Each rank of a model group holds one shard of the parameter tree, a plain
dict of tensors like the whole one (`shard_params`). The cuts follow the
JAX package's rule table (`parallel/mesh.py`), with whole heads where the
port's attention kernels need them:
  qkv_kernel, q_bias, v_bias   by heads within each of q, k and v
  proj kernel                  its input rows, by the same heads
  scale_mul (cos_attn)         by heads (the rule table replicates it)
  fc1 (kernel, bias)           column-parallel: a contiguous cut
  fc2 kernel                   row-parallel: its input rows
  ada_lin (kernel, bias)       column-parallel: a contiguous cut of 6C
  head (kernel, bias)          column-parallel over the vocabulary
Everything else stays whole on every rank, as the rule table replicates
it: the embeddings (with `special_embed` of the separator option and
`type_embed` of type_pos), the proj and fc2 biases, `head_nm`, and
shared_aln's `shared_ada_lin` and `ada_gss`. A leaf whose axis does not
divide stays whole, as `param_shardings` falls back (the separator's
V + 18 head columns: 4114 at d16, cut at model = 2, whole at model = 4);
for the attention leaves "divides" means num_heads % model == 0, so
ControlVAR-d30 (30 heads) at model = 4 keeps its attention replicated and
splits its MLP and ada_lin; for fc1 and fc2 it means the MLP width
divides, for ada_lin 6C, so any model axis runs (d16's MLP width 4096 at
model = 3: only ada_lin is cut). The blocks pick each leaf's collectives
by its width (`models/transformer.py:_split`).

The collectives of the sharded blocks are Megatron's "f" and "g" operators
and a gather, as autograd Functions:
  `copy_to_model`      identity forward, all-reduce backward: the input of
                       a column-parallel product;
  `reduce_from_model`  all-reduce forward (in fp32), identity backward: the
                       output of a row-parallel product, before its bias;
  `gather_from_model`  a zeroed full-width buffer that each rank fills with
                       its slice, then one all_reduce(SUM), which is exact;
                       its backward takes the rank's slice.
Every collective here is an `all_reduce` or a `broadcast`, so the same code
runs on NCCL (a card per rank) and on gloo (ranks that share one card, and
the CPU): gloo takes CUDA tensors for both and stages them through host
memory itself.

A LoRA factor pair (A, B) of a target kernel stays whole on every rank;
each rank adds to its shard of the kernel the same cut of the whole delta
(`shard_of`, which autograd follows, through `ckpt/lora.py:apply_lora`).
The factors of a cut kernel (`lora_cut_keys`) then hold on each rank the
part of their gradient that its shard gives, summed over the model group
by `sum_over_model_`; the factors of a whole kernel hold the whole
gradient on every rank already.

`gather_params` inverts `shard_params` bit for bit (each shard is
broadcast from its rank, whole), and `gather_opt_state`/`shard_opt_state`
do the same for the AdamW moments, so checkpoints hold whole trees, as the
JAX package's Orbax checkpoints hold global arrays.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from controlvar_tpu_torch.train.param_groups import decay_group_names, named_leaves

Params = Dict


class Split(NamedTuple):
    """How a leaf is cut: dimension `dim` is viewed as (groups, parts,
    rest), and model index r of m takes parts [r p/m, (r+1) p/m) of every
    group."""

    dim: int
    groups: int
    parts: int


_HEAD_LEAVES = {"qkv_kernel": (2, 3), "q_bias": (1, 1), "v_bias": (1, 1),
                "proj/kernel": (1, 1), "scale_mul": (1, 1)}
_COLUMN_LEAVES = {"fc1/kernel": 2, "fc1/bias": 1, "fc2/kernel": 1, "ada_lin/kernel": 2,
                  "ada_lin/bias": 1}


def _column_width(sub: str, cfg) -> int:
    """The width that a column leaf is cut along: 6C for ada_lin, the MLP
    width for fc1 and fc2."""
    if sub.startswith("ada_lin"):
        return 6 * cfg.embed_dim
    return round(cfg.embed_dim * cfg.mlp_ratio)


def leaf_split(name: str, cfg, model: int) -> Optional[Split]:
    """The cut of the leaf `name` (a `named_leaves` path) of a model of
    config cfg on a model axis of `model`; None where it stays whole."""
    if model == 1:
        return None
    if name.startswith("blocks/"):
        sub = name[len("blocks/"):]
        if sub in _HEAD_LEAVES and cfg.num_heads % model == 0:
            dim, groups = _HEAD_LEAVES[sub]
            return Split(dim, groups, cfg.num_heads)
        if sub in _COLUMN_LEAVES and _column_width(sub, cfg) % model == 0:
            return Split(_COLUMN_LEAVES[sub], 1, model)
        return None
    if name in ("head/kernel", "head/bias") and getattr(cfg, "head_vocab",
                                                         cfg.vocab_size) % model == 0:
        return Split(1 if name == "head/kernel" else 0, 1, model)
    return None


def _map_named(fn: Callable, tree, prefix: str = ""):
    """A tree like `tree` with fn(name, leaf) at every leaf."""
    if tree is None:
        return None
    join = lambda k: f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_named(fn, v, join(i)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def _view(t: torch.Tensor, s: Split, parts: int) -> torch.Tensor:
    d = s.dim
    return t.reshape(*t.shape[:d], s.groups, parts, -1, *t.shape[d + 1:])


def shard_of(t: torch.Tensor, s: Split, model: int, index: int) -> torch.Tensor:
    """Model index `index`'s shard of the whole tensor t, in t's graph: the
    gradient of the shard flows back into t's slice of it (a LoRA delta)."""
    per = s.parts // model
    shard = _view(t, s, s.parts).narrow(s.dim + 1, index * per, per)
    return shard.reshape(*t.shape[:s.dim], -1, *t.shape[s.dim + 1:])


def cut(t: torch.Tensor, s: Split, model: int, index: int) -> torch.Tensor:
    """Model index `index`'s shard of the whole leaf t, in its own storage
    (detached from t's graph)."""
    return shard_of(t.detach(), s, model, index).clone()


def lora_cut_keys(lora: Params, cfg, model: int) -> List[str]:
    """The keys of a LoRA tree (its targets' leaf names) whose kernel a
    model axis of `model` cuts: their factors' gradients are partial on
    each rank."""
    return [key for key in lora if leaf_split(key, cfg, model) is not None]


def merge(shards: Sequence[torch.Tensor], s: Split) -> torch.Tensor:
    """The whole leaf of its shards in model-index order (`cut`'s
    inverse)."""
    per = s.parts // len(shards)
    t = shards[0]
    whole = torch.cat([_view(x, s, per) for x in shards], dim=s.dim + 1)
    return whole.reshape(*t.shape[:s.dim], -1, *t.shape[s.dim + 1:])


def shard_params(mesh, params: Params, model_index: int, cfg) -> Params:
    """Model index `model_index`'s shard of the whole tree `params` (a
    model of config cfg) on `mesh`, every leaf in storage of its own and
    detached: a shard's training never writes into `params`."""
    def one(name, t):
        s = leaf_split(name, cfg, mesh.model)
        return t.detach().clone() if s is None else cut(t, s, mesh.model, model_index)

    return _map_named(one, params)


def merge_shards(shards: Sequence[Params], cfg) -> Params:
    """The whole tree of a model of config cfg from the shards of every
    model index, in order (the whole leaves are taken from the first)."""
    model = len(shards)
    flat = [dict(named_leaves(sh)) for sh in shards]

    def one(name, t):
        s = leaf_split(name, cfg, model)
        return t if s is None else merge([f[name] for f in flat], s)

    return _map_named(one, shards[0])


def _all_shards(t: torch.Tensor, mesh) -> List[torch.Tensor]:
    """Every model index's shard of a cut leaf whose shard this rank holds,
    each broadcast whole from its rank: the same bits on every rank."""
    out = []
    for j in range(mesh.model):
        buf = t.detach().clone() if j == mesh.model_index else torch.empty_like(t)
        dist.broadcast(buf, src=mesh.model_root + j, group=mesh.model_group)
        out.append(buf)
    return out


def gather_params(mesh, params: Params, cfg) -> Params:
    """The whole tree of this rank's shard `params`, on every rank of its
    model group (a collective: every rank of the group calls it), bit for
    bit `merge_shards` of the shards. Leaves that stay whole are detached
    as they are."""
    def one(name, t):
        s = leaf_split(name, cfg, mesh.model)
        if s is None:
            return t.detach()
        return merge(_all_shards(t, mesh), s)

    return _map_named(one, params)


# ---- the AdamW state --------------------------------------------------------

def _state_names(opt_state: Dict, params: Params) -> List[str]:
    """The leaf name of every parameter index of a state_dict of the
    optimizer that `train_step.make_optimizer` made over `params` (whole or
    a shard: the same names in the same order)."""
    decay, no_decay = decay_group_names(params)
    names = decay + no_decay
    count = sum(len(g["params"]) for g in opt_state["param_groups"])
    if count != len(names):
        raise ValueError(f"an optimizer state over {count} parameters for a tree of "
                         f"{len(names)} leaves")
    return names


def opt_state_shardings(mesh, opt_state: Dict, params: Params, cfg) -> Dict:
    """{parameter index: {key: Split or None}} of an AdamW state_dict:
    the moments follow their parameter's cut, the step count and the
    hyperparameters stay whole."""
    names = _state_names(opt_state, params)
    return {i: {k: (leaf_split(names[i], cfg, mesh.model)
                    if k in ("exp_avg", "exp_avg_sq") else None) for k in st}
            for i, st in opt_state["state"].items()}


def _map_state(opt_state: Dict, specs: Dict, fn) -> Dict:
    state = {i: {k: (v if specs[i][k] is None else fn(v, specs[i][k])) for k, v in st.items()}
             for i, st in opt_state["state"].items()}
    return {"state": state, "param_groups": opt_state["param_groups"]}


def shard_opt_state(mesh, opt_state: Dict, params: Params, cfg) -> Dict:
    """This rank's shard of a whole AdamW state_dict (a checkpoint's), for
    `load_state_dict` into the optimizer over its shard `params`."""
    specs = opt_state_shardings(mesh, opt_state, params, cfg)
    return _map_state(opt_state, specs,
                      lambda v, s: cut(v, s, mesh.model, mesh.model_index))


def gather_opt_state(mesh, opt_state: Dict, params: Params, cfg) -> Dict:
    """The whole AdamW state_dict of this rank's (a collective over the
    model group), bit for bit."""
    specs = opt_state_shardings(mesh, opt_state, params, cfg)
    return _map_state(opt_state, specs, lambda v, s: merge(_all_shards(v, mesh), s))


# ---- the collectives of the sharded blocks -----------------------------------

def _sum_over_model(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of t over the model group in fp32 (half types are summed in
    fp32 and cast back: the collectives never reduce in bf16)."""
    out = t.float().clone() if t.dtype in (torch.bfloat16, torch.float16) else t.clone()
    dist.all_reduce(out, group=mesh.model_group)
    return out.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):
        return _sum_over_model(g, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.dtype = x.dtype
        out = x.float().clone()
        dist.all_reduce(out, group=mesh.model_group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        w = x.shape[-1]
        ctx.lo, ctx.w = mesh.model_index * w, w
        full = x.new_zeros(*x.shape[:-1], w * mesh.model)
        full[..., ctx.lo: ctx.lo + w] = x
        return _sum_over_model(full, mesh)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo: ctx.lo + ctx.w].contiguous(), None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """x, whose gradient is summed over the model group in the backward:
    the replicated input of a column-parallel product."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The fp32 sum over the model group of a row-parallel product's
    partial output x; the gradient passes through (cast to x's dtype)."""
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The model group's slices of the last dimension, in model-index
    order, on every rank; the gradient of a rank's slice is its part of the
    whole gradient."""
    return _GatherFromModel.apply(x, mesh)


def broadcast_from_model_root(t: torch.Tensor, mesh) -> torch.Tensor:
    """t as model index 0 of this rank's model group holds it, in place on
    every rank of the group (a sampler's draw)."""
    dist.broadcast(t, src=mesh.model_root, group=mesh.model_group)
    return t


def sum_over_model_(tensors: Sequence[torch.Tensor], mesh) -> None:
    """Replace every tensor by its sum over the model group, in place,
    through one fp32 all-reduce of their concatenation (every rank ends
    with the same bits)."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=mesh.model_group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset: offset + t.numel()].view_as(t))
        offset += t.numel()


def square_sum(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The fp64 sum of the squares of every element of `tensors` (0 for
    none). fp64, as the JAX package's pairwise fp32 sums are close to
    exact: torch's fp32 norm on the CPU sums in order and reads 0.3% low
    over the 2.2e7 elements of a d30-width qkv kernel's gradient."""
    if not tensors:
        return torch.zeros((), dtype=torch.float64)
    return torch.stack([torch.linalg.vector_norm(t, dtype=torch.float64) ** 2
                        for t in tensors]).sum()


def sum_of_squares(grads: Sequence[torch.Tensor], split: Sequence[bool], mesh) -> torch.Tensor:
    """The fp32 sum of squares of every gradient of the whole model from
    this rank's shard: the cut leaves' squares summed over the model group,
    each whole leaf counted once."""
    cut_sq = square_sum([g for g, s in zip(grads, split) if s]).to(grads[0].device)
    whole_sq = square_sum([g for g, s in zip(grads, split) if not s]).to(grads[0].device)
    dist.all_reduce(cut_sq, group=mesh.model_group)
    return (cut_sq + whole_sq).float()
