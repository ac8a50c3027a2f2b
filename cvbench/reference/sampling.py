"""The kept set of a top-k / top-p draw (VAR's `sample_with_top_k_top_p_`):
the k largest logits, then, renormalised over them, every token whose mass
strictly above it is under top_p (the token that crosses top_p is kept,
the most likely one always).

`mass_above` places drawn ids against that rule: 1 for an id outside the
top k, else the share of the top k's mass that lies strictly above it. An
id is kept exactly when its mass above is under top_p.
"""
from __future__ import annotations

import torch


def _top_k_weights(logits: torch.Tensor, top_k: int):
    """exp(logit - max) over the top-k set, 0 elsewhere; and the set."""
    logits = logits.float()
    V = logits.shape[-1]
    if 0 < top_k < V:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        in_k = logits >= kth
    else:
        in_k = torch.ones_like(logits, dtype=torch.bool)
    e = torch.where(in_k, torch.exp(logits - logits.max(dim=-1, keepdim=True).values), 0.0)
    return e, in_k


def mass_above(logits: torch.Tensor, ids: torch.Tensor, top_k: int) -> torch.Tensor:
    """(N,) share of the top-k set's mass strictly above each id's logit, or
    1 where the id lies outside the set. logits (N, V), ids (N,)."""
    e, in_k = _top_k_weights(logits, top_k)
    ids = ids.reshape(-1, 1).long()
    mine = logits.float().gather(1, ids)
    above = torch.where(logits.float() > mine, e, 0.0).sum(-1) / e.sum(-1)
    return torch.where(in_k.gather(1, ids)[:, 0], above, torch.ones_like(above))


def kept_mask(logits: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """(N, V) bool: the kept set of each row."""
    e, in_k = _top_k_weights(logits, top_k)
    if top_p <= 0.0:
        return in_k
    w, order = torch.sort(e, dim=-1, descending=True)
    before = (torch.cumsum(w, dim=-1) - w) / w.sum(-1, keepdim=True)
    keep_sorted = before < top_p
    keep_sorted[..., 0] = True
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return keep & in_k


def draw(logits: torch.Tensor, top_k: int, top_p: float,
         generator: torch.Generator) -> torch.Tensor:
    """(N,) ids drawn from the kept set of each row by gumbel-max."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    g = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    kept = kept_mask(logits, top_k, top_p)
    return torch.argmax(torch.where(kept, logits.float() + g, float("-inf")), dim=-1)
