"""Generation harness: joint (control, image) generation, and pixel-
conditional generation (tokenize the condition image, teacher-force its
tokens, generate the other stream), with optional Gibbs refinement; the
canvases come back decoded."""
from __future__ import annotations

import dataclasses

import torch

from controlvar_tpu_torch.config import SampleConfig
from controlvar_tpu_torch.device import DeviceLike, resolve_device
from controlvar_tpu_torch.eval.stepwise import StepwiseCondSampler, StepwiseJointSampler
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.vqvae import VQVAE


@dataclasses.dataclass
class SamplingHarness:
    """Entry point of generation. Runs on `cuda` unless device="cpu" is
    passed.

    sample_cfg.kv_window sends all three samplers to the segmented cache
    mode (K5 on the card); inplace_decode sends their stacked caches through
    K6. decode_generated_only decodes only the generated canvas in the
    conditional modes (the forced stream is the caller's input); the other
    member of the returned pair is then its raw f_hat, not pixels."""

    model: ControlVARModel
    vqvae: VQVAE
    sample_cfg: SampleConfig = SampleConfig()
    compute_dtype: torch.dtype = torch.bfloat16
    device: DeviceLike = None
    decode_generated_only: bool = False
    inplace_decode: bool = False

    def __post_init__(self):
        self.device = resolve_device(self.device)
        sc = self.sample_cfg
        common = dict(top_k=sc.top_k, top_p=sc.top_p, more_smooth=sc.more_smooth,
                      inplace_decode=self.inplace_decode, device=self.device,
                      compute_dtype=self.compute_dtype)
        if sc.kv_window is not None:
            common.update(cache_mode="seg", kv_window=sc.kv_window)
        self._joint = StepwiseJointSampler(self.model, self.vqvae, cfg_scale=sc.cfg[0],
                                           **common)
        only = self.decode_generated_only
        self._cond_mask = StepwiseCondSampler(self.model, self.vqvae, cfg_scales=sc.cfg,
                                              force="control",
                                              decode="image" if only else "both", **common)
        self._cond_img = StepwiseCondSampler(self.model, self.vqvae, cfg_scales=sc.cfg,
                                             force="image",
                                             decode="control" if only else "both", **common)

    def prepare_params(self, params):
        """Cast the block weights to the compute dtype once; call before a
        generation run."""
        return self._joint.prepare_params(params)

    def _tokenize(self, vq_params, img):
        return self.vqvae.img_to_ids(vq_params, img.to(self.device),
                                     compute_dtype=self.compute_dtype)

    def joint(self, params, vq_params, labels, cond_type, generator, **kw):
        """Joint (control, image) generation -> two (B, H, W, 3) in [0, 1]."""
        return self._joint(params, vq_params, labels, cond_type, generator, **kw)

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

    def gibbs_refine(self, params, vq_params, labels, cond_type, generator,
                     img_c, img_i, steps: int = 1):
        """Alternate control-forced and image-forced passes `steps` times
        (the reference's train_control_var_hpu.py:380-393). Canvases in
        [0, 1]; both are consumed as pixels."""
        if self.decode_generated_only:
            raise ValueError("gibbs_refine consumes both canvases as pixels; build the "
                             "harness with decode_generated_only=False")
        for _ in range(steps):
            img_c, img_i = self.control_conditioned(params, vq_params, labels, cond_type,
                                                    generator, img_c * 2.0 - 1.0)
            img_c, img_i = self.image_conditioned(params, vq_params, labels, cond_type,
                                                  generator, img_i * 2.0 - 1.0)
        return img_c, img_i
