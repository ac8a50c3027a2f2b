"""Standalone class-conditioning embedder with cond-drop.

Port of `controlvar_tpu/models/class_embedder.py`, itself an API-parity
port of the reference ClassEmbedder: the reference's trainers build one but
never read its output (VAR and ControlVAR embed classes themselves), so it
is kept for interface completeness. The cond-drop draw comes from an
explicit generator.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from controlvar_tpu_torch.device import DeviceLike, resolve_device

Params = Dict


def init_params(generator: torch.Generator, num_classes: int, embed_dim: int,
                device: DeviceLike = None) -> Params:
    """{"embedding": (num_classes + 1, embed_dim)}: 0.02 times a standard
    normal truncated at +-2; row num_classes is the null class."""
    t = torch.empty(num_classes + 1, embed_dim)
    torch.nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0, generator=generator)
    return {"embedding": (0.02 * t).to(resolve_device(device))}


def apply(params: Params, labels: torch.Tensor, num_classes: int,
          cond_drop_rate: float = 0.1, generator: Optional[torch.Generator] = None,
          train: bool = False) -> torch.Tensor:
    """labels (B,) -> embeddings (B, C); when training with a generator, each
    label becomes the null class with probability cond_drop_rate."""
    if train and generator is not None and cond_drop_rate > 0:
        u = torch.rand(labels.shape, generator=generator).to(labels.device)
        labels = torch.where(u < cond_drop_rate, num_classes, labels)
    return params["embedding"][labels]
