"""Multi-scale VQVAE tokenizer: encoder + quant_conv + residual VQ +
post_quant_conv + decoder. Images and f_hat are NHWC.

Params: {"encoder": ..., "decoder": ..., "quant_conv": {kernel, bias},
         "post_quant_conv": {kernel, bias}, "quantize": {embedding, phi}}
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from controlvar_tpu_torch.config import VQVAEConfig
from controlvar_tpu_torch.device import (DeviceLike, generator_for,
                                        resolve_device, tree_to)
from controlvar_tpu_torch.models import vae as vae_mod
from controlvar_tpu_torch.models.quantizer import MultiScaleQuantizer

Params = Dict


class VQVAE:
    """Tokenizer entry point. Runs on `cuda` unless device="cpu" is passed."""

    def __init__(self, cfg: VQVAEConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.quantizer = MultiScaleQuantizer(cfg)

    def init_params(self, seed: int) -> Params:
        """torch-default initialized params from a seed, on self.device."""
        g = generator_for(seed)
        ks, z = self.cfg.quant_conv_ks, self.cfg.z_channels
        params = {
            "encoder": vae_mod.init_encoder_params(g, self.cfg),
            "decoder": vae_mod.init_decoder_params(g, self.cfg),
            "quantize": self.quantizer.init_params(g),
            "quant_conv": vae_mod._init_conv(g, ks, ks, z, z),
            "post_quant_conv": vae_mod._init_conv(g, ks, ks, z, z),
        }
        return tree_to(params, self.device)

    def encode_f(self, params: Params, img: torch.Tensor,
                 compute_dtype=torch.float32) -> torch.Tensor:
        """img (B, H, W, 3) in [-1, 1] -> pre-quant feature (B, H/16, W/16, Cvae) fp32."""
        f = vae_mod.encoder_apply(params["encoder"], img, self.cfg, compute_dtype)
        with vae_mod.precision_scope(compute_dtype):
            f = vae_mod._conv(params["quant_conv"], f.permute(0, 3, 1, 2))
        return f.permute(0, 2, 3, 1).float()

    def img_to_ids(self, params: Params, img: torch.Tensor,
                   patch_nums: Optional[Sequence[int]] = None,
                   compute_dtype=torch.float32) -> List[torch.Tensor]:
        """Tokenize: per-scale (B, pn*pn) int64 ids."""
        f = self.encode_f(params, img, compute_dtype)
        return self.quantizer.encode_ids(params["quantize"], f, patch_nums)

    def decode_raw(self, params: Params, f_hat: torch.Tensor,
                   compute_dtype=torch.float32) -> torch.Tensor:
        """post_quant_conv + decoder, unclamped, fp32 NHWC."""
        with vae_mod.precision_scope(compute_dtype):
            h = vae_mod._conv(params["post_quant_conv"],
                              f_hat.to(compute_dtype).permute(0, 3, 1, 2))
        img = vae_mod.decoder_apply(params["decoder"], h.permute(0, 2, 3, 1),
                                    self.cfg, compute_dtype)
        return img.float()

    def fhat_to_img(self, params: Params, f_hat: torch.Tensor,
                    compute_dtype=torch.float32) -> torch.Tensor:
        """f_hat (B, h, w, Cvae) -> image (B, 16h, 16w, 3) clamped to [-1, 1]."""
        return self.decode_raw(params, f_hat, compute_dtype).clamp(-1.0, 1.0)
