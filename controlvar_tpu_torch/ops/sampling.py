"""Token sampling: top-k/top-p filtered draw, or a plain categorical."""
from __future__ import annotations

from typing import Optional

import torch

from controlvar_tpu_torch.ops.sample_kernel import (NEG_INF, gumbel_noise,
                                                    sample_top_k_top_p_bisect)

__all__ = ["NEG_INF", "sample_top_k_top_p"]


def sample_top_k_top_p(logits: torch.Tensor, top_k: int = 0, top_p: float = 0.0,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sample ids (...,) int64 from top-k/top-p filtered logits (..., V).

    With a filter the draw is the bisection sampler (K2: the kernel on CUDA
    tensors, its plain version on CPU tensors); without one it is a plain
    categorical, by gumbel-max over all logits with noise made on the logits'
    device (seeded from `generator` when that is not the CPU)."""
    if top_k > 0 or top_p > 0.0:
        return sample_top_k_top_p_bisect(logits, top_k, top_p, generator=generator)
    g = gumbel_noise(logits.shape, generator, logits.device)
    return torch.argmax(logits.float() + g, dim=-1)
