"""Pixel-conditional generation harness: tokenize the condition image,
teacher-force its tokens, generate the other stream, decode the canvases."""
from __future__ import annotations

import dataclasses

import torch

from controlvar_tpu_torch.config import SampleConfig
from controlvar_tpu_torch.device import DeviceLike, resolve_device
from controlvar_tpu_torch.eval.stepwise import StepwiseCondSampler
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.vqvae import VQVAE


@dataclasses.dataclass
class SamplingHarness:
    """Entry point of conditional generation. Runs on `cuda` unless
    device="cpu" is passed."""

    model: ControlVARModel
    vqvae: VQVAE
    sample_cfg: SampleConfig = SampleConfig()
    compute_dtype: torch.dtype = torch.bfloat16
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        sc = self.sample_cfg
        common = dict(cfg_scales=sc.cfg, top_k=sc.top_k, top_p=sc.top_p,
                      device=self.device, compute_dtype=self.compute_dtype)
        self._cond_mask = StepwiseCondSampler(self.model, self.vqvae, force="control",
                                              **common)
        self._cond_img = StepwiseCondSampler(self.model, self.vqvae, force="image", **common)

    def prepare_params(self, params):
        """Cast the block weights to the compute dtype once; call before a
        generation run."""
        return self._cond_mask.prepare_params(params)

    def _tokenize(self, vq_params, img):
        return self.vqvae.img_to_ids(vq_params, img.to(self.device),
                                     compute_dtype=self.compute_dtype)

    def control_conditioned(self, params, vq_params, labels, cond_type, generator,
                            control_imgs, **kw):
        """Teacher-force the control stream from control images (B,H,W,3) in [-1,1]."""
        c_mask = self._tokenize(vq_params, control_imgs)
        return self._cond_mask(params, vq_params, labels, cond_type, generator, c_mask, **kw)

    def image_conditioned(self, params, vq_params, labels, cond_type, generator,
                          imgs, **kw):
        """Teacher-force the image stream (control prediction mode)."""
        c_img = self._tokenize(vq_params, imgs)
        return self._cond_img(params, vq_params, labels, cond_type, generator, c_img, **kw)
