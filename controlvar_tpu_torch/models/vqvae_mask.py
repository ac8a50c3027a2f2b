"""Dual-codebook mask VQVAE: joint image+mask tokenization.

Used by tokenizer training (reference: models/vqvae_mask.py:16-80,
train_vqvae.py:24): two codebooks (`mask_quantize`, `quantize`) share one
encoder and decoder; the image latent is first explained by the mask
codebook, a `filter` conv cleans the residual, and the pixel codebook
quantizes what remains. The mask branch's encoder pass and its decode run
without gradient.

Params: the VQVAE's plus {"mask_quantize": {...}, "filter": conv}.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from controlvar_tpu_torch.models import vae as vae_mod
from controlvar_tpu_torch.models.vqvae import VQVAE

Params = Dict


class MaskVQVAE(VQVAE):
    """VQVAE with the second codebook and the filter conv. Runs on `cuda`
    unless device="cpu" is passed."""

    def _init_host(self, g: torch.Generator) -> Params:
        p = super()._init_host(g)
        p["mask_quantize"] = self.quantizer.init_params(g)
        ks, z = self.cfg.quant_conv_ks, self.cfg.z_channels
        p["filter"] = vae_mod._init_conv(g, ks, ks, z, z)
        return p

    def _filter(self, params: Params, x: torch.Tensor, compute_dtype=torch.float32):
        """The filter conv on NHWC, fp32 out."""
        with vae_mod.precision_scope(compute_dtype):
            y = vae_mod._conv(params["filter"], x.to(compute_dtype).permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1).float()

    def forward_train_joint(
        self, params: Params, img: torch.Tensor, msk: torch.Tensor,
        compute_dtype=torch.float32,
    ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, torch.Tensor],
               torch.Tensor, torch.Tensor]:
        """(recon_img, recon_msk, (pixel_hits, mask_hits), mask_vq_loss,
        vq_loss), as MaskVQVAE.forward (reference: vqvae_mask.py:67-80);
        hits are per-scale codebook hit counts (S, V)."""
        quant = self.quantizer
        latent_img = self.encode_f(params, img, compute_dtype)
        with torch.no_grad():
            latent_msk = self.encode_f(params, msk, compute_dtype)
        # mask branch: no grad into its input; the mask codebook still learns
        mh, mvq_loss, m_hits = quant.quantize_train(params["mask_quantize"], latent_msk)
        # the image latent explained by the mask codebook first
        h1, _, _ = quant.quantize_train(params["mask_quantize"], latent_img)
        latent_pixel = self._filter(params, latent_img - h1, compute_dtype)
        h2, vq_loss, hits = quant.quantize_train(params["quantize"], latent_pixel)
        with torch.no_grad():
            recon_msk = self.decode_raw(params, self._filter(params, mh, compute_dtype),
                                        compute_dtype)
        recon_img = self.decode_raw(params, self._filter(params, h1, compute_dtype) + h2,
                                    compute_dtype)
        return recon_img, recon_msk, (hits, m_hits), mvq_loss, vq_loss
