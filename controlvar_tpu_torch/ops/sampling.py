"""Token sampling: top-k/top-p filtered draws, a plain categorical, and
gumbel-softmax smoothing.

Port of `controlvar_tpu/ops/sampling.py`. A filtered draw takes one of two
routes, chosen by `method`:
  "auto", "bisect", "bisect_prng": the bisection sampler (K2: the kernel on
      CUDA tensors, which draws its own Philox noise, its plain version on
      CPU tensors);
  "sort": one descending sort of the logits (bf16 keys when top_k > 64),
      the nucleus mask in sorted space, and a gumbel-max draw over the kept
      sorted entries (the JAX package's `--sampler sort`).
Both draw from the same distribution with other random streams. The JAX
package reads its default from `CONTROLVAR_SAMPLER`; the port takes it as
an argument only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from controlvar_tpu_torch.ops.sample_kernel import (NEG_INF, gumbel_noise,
                                                    sample_top_k_top_p_bisect)

__all__ = ["METHODS", "NEG_INF", "filtered_sorted_logits", "gumbel_softmax",
           "sample_top_k_top_p", "smooth_temperature", "top_k_top_p_filter"]

METHODS = ("auto", "sort", "bisect", "bisect_prng")


def top_k_top_p_filter(logits: torch.Tensor, top_k: int = 0,
                       top_p: float = 0.0) -> torch.Tensor:
    """Set logits (..., V) outside the top-k and the nucleus top-p to -1e30.

    top-p in the reference's ascending form: sort ascending, drop entries
    whose ascending cumulative probability is <= 1 - top_p, never the most
    likely one. Sorts are stable, so among equal logits the lower index
    comes first, as in `jnp.argsort`."""
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p > 0.0:
        sorted_logits, sort_idx = torch.sort(logits, dim=-1, stable=True)
        cum = torch.cumsum(torch.softmax(sorted_logits.float(), dim=-1), dim=-1)
        remove_sorted = cum <= (1.0 - top_p)
        remove_sorted[..., -1] = False
        remove = torch.empty_like(remove_sorted).scatter_(-1, sort_idx, remove_sorted)
        logits = torch.where(remove, NEG_INF, logits)
    return logits


def filtered_sorted_logits(logits: torch.Tensor, top_k: int = 0,
                           top_p: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deterministic half of the sort route: the kept logits (..., K)
    in descending order, fp32, with dropped nucleus entries at -1e30, and
    their vocab ids (..., K).

    For top_k > 64 the sort runs on bf16-rounded keys and the values come
    back rounded (the JAX package's trade-off, bounded in
    tests/test_sampling_stats.py); below it the selection is exact fp32, so
    greedy top_k=1 is the fp32 argmax. `lax.top_k` orders floats totally
    (+0 above -0) and puts the lower index first among equal values; a
    stable descending sort of the keys' order-preserving int32 images does
    the same."""
    V = logits.shape[-1]
    K = top_k if top_k > 0 else V
    keys = logits.to(torch.bfloat16).float() if top_k > 64 else logits.float()
    bits = keys.view(torch.int32)
    order = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # monotone in the float's total order
    idx = torch.sort(order, dim=-1, descending=True, stable=True).indices[..., :K]
    vals = keys.gather(-1, idx)
    if top_p > 0.0:
        probs = torch.softmax(vals, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        keep[..., 0] = True
        vals = torch.where(keep, vals, NEG_INF)
    return vals, idx


def sample_top_k_top_p(logits: torch.Tensor, top_k: int = 0, top_p: float = 0.0,
                       generator: Optional[torch.Generator] = None,
                       method: str = "auto") -> torch.Tensor:
    """Sample ids (...,) int64 from top-k/top-p filtered logits (..., V).

    Without a filter the draw is a plain categorical, by gumbel-max over all
    logits with noise made on the logits' device (seeded from `generator`
    when that is not the CPU). With one, `method` picks the route (see the
    module docstring)."""
    if top_k <= 0 and top_p <= 0.0:
        g = gumbel_noise(logits.shape, generator, logits.device)
        return torch.argmax(logits.float() + g, dim=-1)
    if method not in METHODS:
        raise ValueError(f"unknown sampling method {method!r}; use one of {METHODS}")
    if method != "sort":
        return sample_top_k_top_p_bisect(logits, top_k, top_p, generator=generator)
    vals, idx = filtered_sorted_logits(logits, top_k, top_p)
    pos = torch.argmax(vals + gumbel_noise(vals.shape, generator, vals.device), dim=-1)
    return idx.gather(-1, pos[..., None])[..., 0]


def gumbel_softmax(logits: torch.Tensor, tau: float, hard: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Gumbel-softmax over the last axis, fp32 (the reference's
    helpers.py:22-36). hard=True returns the one-hot of the argmax with the
    soft sample's gradient (straight-through, as `F.gumbel_softmax`: the
    JAX package's `y_hard + sg(y_soft) - y_soft` carries the negated
    gradient; no sampler differentiates through it)."""
    g = gumbel_noise(logits.shape, generator, logits.device)
    y_soft = torch.softmax((logits.float() + g) / tau, dim=-1)
    if not hard:
        return y_soft
    idx = torch.argmax(y_soft, dim=-1)
    y_hard = torch.nn.functional.one_hot(idx, logits.shape[-1]).to(y_soft.dtype)
    return y_hard - y_soft.detach() + y_soft


def smooth_temperature(si: int, num_scales: int) -> Tuple[float, float]:
    """more_smooth's (logit factor, gumbel temperature) at scale si."""
    ratio = si / (num_scales - 1)
    return 1.0 + ratio, max(0.27 * (1 - ratio * 0.95), 0.005)
