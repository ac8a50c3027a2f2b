"""Dice / BCE segmentation losses (reference: losses/dice.py:3-13,
losses/segmentation.py:5-22; present in the reference but unused by any
trainer, kept for API completeness)."""
from __future__ import annotations

import torch


def dice_loss(logits: torch.Tensor, targets: torch.Tensor,
              smooth: float = 1.0) -> torch.Tensor:
    """Soft dice over flattened predictions. logits/targets: (B, ...)."""
    probs = torch.sigmoid(logits).reshape(logits.shape[0], -1)
    t = targets.reshape(targets.shape[0], -1)
    inter = torch.sum(probs * t, dim=1)
    denom = torch.sum(probs, dim=1) + torch.sum(t, dim=1)
    return torch.mean(1.0 - (2.0 * inter + smooth) / (denom + smooth))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.mean(
        torch.clamp_min(logits, 0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    )


def bce_dice_loss(logits: torch.Tensor, targets: torch.Tensor,
                  bce_weight: float = 0.5) -> torch.Tensor:
    return bce_weight * bce_with_logits(logits, targets) + (1 - bce_weight) * dice_loss(
        logits, targets
    )
