"""Composite VQVAE training loss: L1 + LPIPS + adversarial with adaptive weight.

The port of `controlvar_tpu/losses/vqperceptual.py` (the taming-style
VQLPIPSWithDiscriminator, reference: losses/vqperceptual.py:34-137):
generator loss = L1 rec + perceptual + codebook + disc_factor *
adaptive_weight * (-E[D(fake)]); discriminator loss = hinge (or vanilla) on
real/fake patch logits; the adaptive weight is ||grad(nll, last_layer)|| /
||grad(g_loss, last_layer)|| clamped to 1e4 (reference:
vqperceptual.py:63-74), with a warm-up step gate on the adversarial terms
(`disc_start`, reference: vqperceptual.py:14-17).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from controlvar_tpu_torch.losses import discriminator as disc_mod
from controlvar_tpu_torch.losses.lpips import lpips_distance

Params = Dict


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real)) + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.softplus(-logits_real)) + torch.mean(F.softplus(logits_fake)))


@dataclasses.dataclass(frozen=True)
class VQLPIPSWithDiscriminator:
    disc_start: int = 0
    codebook_weight: float = 1.0
    pixel_weight: float = 1.0
    perceptual_weight: float = 1.0
    disc_factor: float = 1.0
    disc_weight: float = 0.8
    disc_loss: str = "hinge"  # or "vanilla"

    def adaptive_weight(self, nll_grad_norm: torch.Tensor,
                        g_grad_norm: torch.Tensor) -> torch.Tensor:
        w = nll_grad_norm / (g_grad_norm + 1e-4)
        return torch.clamp(w, 0.0, 1e4) * self.disc_weight

    def _disc_factor(self, global_step) -> float:
        """disc_factor from disc_start on, 0 before."""
        return self.disc_factor if int(global_step) >= self.disc_start else 0.0

    def _d_weight(self, last_layer_grads, like: torch.Tensor) -> torch.Tensor:
        if last_layer_grads is not None:
            return self.adaptive_weight(*last_layer_grads)
        return like.new_tensor(self.disc_weight)

    def generator_loss(
        self,
        lpips_params: Params,
        disc_params: Params,
        inputs: torch.Tensor,        # (B, H, W, 3) targets in [-1, 1]
        recons: torch.Tensor,        # (B, H, W, 3)
        codebook_loss: torch.Tensor,
        global_step,
        last_layer_grads: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ):
        """Returns (loss, metrics). `last_layer_grads` = (||dnll/dw||,
        ||dg/dw||) at the decoder's output conv, without gradient; None
        disables the adaptive weight (weight = disc_weight)."""
        rec = torch.abs(inputs - recons)
        p = lpips_distance(lpips_params, inputs, recons)
        nll = torch.mean(rec) * self.pixel_weight + self.perceptual_weight * torch.mean(p)
        logits_fake = disc_mod.apply(disc_params, recons)
        g_loss = -torch.mean(logits_fake)
        d_weight = self._d_weight(last_layer_grads, nll)
        loss = (nll + d_weight * self._disc_factor(global_step) * g_loss
                + self.codebook_weight * codebook_loss)
        return loss, {
            "nll": nll, "g_loss": g_loss, "d_weight": d_weight,
            "codebook": codebook_loss, "perceptual": torch.mean(p),
            "rec_l1": torch.mean(rec),
        }

    def generator_loss_dual(
        self,
        lpips_params: Params,
        disc_params: Params,
        images: torch.Tensor,            # (B, H, W, 3) in [-1, 1]
        masks: torch.Tensor,
        recon_img: torch.Tensor,
        recon_msk: torch.Tensor,
        codebook_loss: torch.Tensor,     # pixel codebook
        m_codebook_loss: torch.Tensor,   # mask codebook
        global_step,
        last_layer_grads: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ):
        """Dual-codebook generator loss: rec/LPIPS/GAN terms averaged over the
        image and mask branches, the codebook term over the two books
        (reference: losses/vqperceptual.py:78-119)."""
        rec = 0.5 * (torch.mean(torch.abs(images - recon_img))
                     + torch.mean(torch.abs(masks - recon_msk)))
        p = 0.5 * (torch.mean(lpips_distance(lpips_params, images, recon_img))
                   + torch.mean(lpips_distance(lpips_params, masks, recon_msk)))
        nll = rec * self.pixel_weight + self.perceptual_weight * p
        logits_fake = 0.5 * (disc_mod.apply(disc_params, recon_img)
                             + disc_mod.apply(disc_params, recon_msk))
        g_loss = -torch.mean(logits_fake)
        d_weight = self._d_weight(last_layer_grads, nll)
        cb = 0.5 * (codebook_loss + m_codebook_loss)
        loss = (nll + d_weight * self._disc_factor(global_step) * g_loss
                + self.codebook_weight * cb)
        return loss, {
            "nll": nll, "g_loss": g_loss, "d_weight": d_weight,
            "codebook": codebook_loss, "mask_codebook": m_codebook_loss,
            "perceptual": p, "rec_l1": rec,
        }

    def _d_loss(self, logits_real, logits_fake, global_step):
        loss_fn = hinge_d_loss if self.disc_loss == "hinge" else vanilla_d_loss
        d_loss = self._disc_factor(global_step) * loss_fn(logits_real, logits_fake)
        return d_loss, {
            "d_loss": d_loss,
            "logits_real": torch.mean(logits_real).detach(),
            "logits_fake": torch.mean(logits_fake).detach(),
        }

    def discriminator_loss_dual(self, disc_params: Params, images, masks, recon_img,
                                recon_msk, global_step):
        """Hinge D loss with real/fake patch logits averaged over both
        branches (reference: losses/vqperceptual.py:121-137); no gradient
        reaches the images or reconstructions."""
        apply = lambda x: disc_mod.apply(disc_params, x.detach())
        logits_real = 0.5 * (apply(images) + apply(masks))
        logits_fake = 0.5 * (apply(recon_img) + apply(recon_msk))
        return self._d_loss(logits_real, logits_fake, global_step)

    def discriminator_loss(self, disc_params: Params, inputs, recons, global_step):
        logits_real = disc_mod.apply(disc_params, inputs)
        logits_fake = disc_mod.apply(disc_params, recons.detach())
        return self._d_loss(logits_real, logits_fake, global_step)
