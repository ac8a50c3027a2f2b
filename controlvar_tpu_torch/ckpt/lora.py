"""LoRA fine-tuning over the port's param trees.

The port of `controlvar_tpu/ckpt/lora.py`. The reference wraps attn.proj /
ffn.fc* / ada_lin.1 / head_nm.ada_lin.1 with peft LoRA adapters (r=16,
alpha=32, reference: train_control_var_hpu.py:449-470). Here LoRA is a
separate tree of (A, B) factors per targeted kernel, merged on the fly:
effective kernel = base + (alpha/r) * A @ B. Training differentiates only
the LoRA tree: `apply_lora` detaches every base leaf, the counterpart of
the JAX package's stop_gradient, so the base carries no gradient while the
activations still carry theirs through every layer.

Stacked block kernels (leading depth axis) get per-layer factors
A (D, in, r) and B (D, r, out); one batched matmul merges all layers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from controlvar_tpu_torch.device import tree_map

Params = Dict

# tree paths of the targeted kernels (reference target_modules, :453-457)
DEFAULT_TARGETS = (
    ("blocks", "proj", "kernel"),
    ("blocks", "fc1", "kernel"),
    ("blocks", "fc2", "kernel"),
    ("blocks", "ada_lin", "kernel"),
    ("head_nm", "ada_lin", "kernel"),
)


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    targets: Tuple[Tuple[str, ...], ...] = DEFAULT_TARGETS

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _get(tree, path) -> Optional[torch.Tensor]:
    for p in path:
        if p not in tree:
            return None
        tree = tree[p]
    return tree


def _set(tree, path, value) -> None:
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value


def init_lora_params(generator: torch.Generator, params: Params, cfg: LoRAConfig) -> Params:
    """A ~ kaiming-uniform (bound sqrt(6 / fan_in)) from `generator`, B = 0,
    fp32 on each kernel's device; keyed by "blocks/proj/kernel" etc."""
    lora: Params = {}
    for path in cfg.targets:
        kernel = _get(params, path)
        if kernel is None:
            continue
        *lead, fan_in, fan_out = kernel.shape
        bound = float(np.sqrt(6.0 / fan_in))
        A = (torch.rand(*lead, fan_in, cfg.rank, generator=generator) * 2 - 1) * bound
        lora["/".join(path)] = {"A": A.to(kernel.device),
                                "B": torch.zeros(*lead, cfg.rank, fan_out, device=kernel.device)}
    return lora


def apply_lora(params: Params, lora: Params, cfg: LoRAConfig,
               freeze_base: bool = True) -> Params:
    """A params tree with the LoRA deltas added to the targeted kernels. The
    delta (alpha/r) * A @ B is computed in fp32 and cast to the kernel's
    dtype. With freeze_base, every base leaf is detached: the base gets no
    gradient, the LoRA factors do."""
    out = tree_map((lambda t: t.detach()) if freeze_base else (lambda t: t), params)
    for key, ab in lora.items():
        path = tuple(key.split("/"))
        kernel = _get(out, path)
        delta = cfg.scale * torch.matmul(ab["A"].float(), ab["B"].float())
        _set(out, path, kernel + delta.to(kernel.dtype))
    return out


@torch.no_grad()
def merge_lora(params: Params, lora: Params, cfg: LoRAConfig) -> Params:
    """Bake the LoRA deltas into the base weights (for export and
    inference); leaves that LoRA does not target are shared with `params`."""
    return apply_lora(params, lora, cfg, freeze_base=False)
