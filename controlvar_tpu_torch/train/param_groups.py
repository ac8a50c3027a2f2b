"""Weight-decay masking over the port's parameter trees.

No decay for the keyword list below (positional, level, class and cond-type
embeddings, AdaLN gammas, cos-attn scales, biases) nor for any parameter of
at most one dimension, counted after the leading depth axis for the stacked
block params.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch

NOWD_KEYWORDS = (
    "pos_1LC", "pos_start", "lvl_embed", "class_emb", "cond_embed",
    "type_embed", "special_embed", "ada_gss", "scale_mul", "gamma", "beta",
    "bias", "q_bias", "v_bias",
)


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """("a/b/c", tensor) for every leaf of a nested dict/list tree, in order;
    a None node (a discriminator layer without BatchNorm) has no leaves."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if v is None:
            continue
        if isinstance(v, (dict, list)):
            yield from named_leaves(v, _join(prefix, k))
        else:
            yield _join(prefix, k), v


def _decays(name: str, leaf: torch.Tensor) -> bool:
    if any(k in name for k in NOWD_KEYWORDS):
        return False
    return leaf.dim() - (1 if "blocks" in name else 0) > 1


def _mask(tree, prefix: str):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _mask(v, _join(prefix, k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_mask(v, _join(prefix, i)) for i, v in enumerate(tree)]
    return _decays(prefix, tree)


def weight_decay_mask(params: Dict) -> Dict:
    """A tree like `params` of bools: True where weight decay applies."""
    return _mask(params, "")


def decay_groups(params: Dict) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(decayed, not decayed) leaves of `params`, each in tree order."""
    decay, no_decay = [], []
    for name, leaf in named_leaves(params):
        (decay if _decays(name, leaf) else no_decay).append(leaf)
    return decay, no_decay


def decay_group_names(params: Dict) -> Tuple[List[str], List[str]]:
    """The leaf names of `decay_groups(params)`, in the same order."""
    decay, no_decay = [], []
    for name, leaf in named_leaves(params):
        (decay if _decays(name, leaf) else no_decay).append(name)
    return decay, no_decay
