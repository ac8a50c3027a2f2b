"""Generation harness: joint (control, image) generation, and pixel-
conditional generation (tokenize the condition image, teacher-force its
tokens, generate the other stream), with optional Gibbs refinement; the
canvases come back decoded. `generate_fid_set` writes the FID-protocol
image set (images_per_class images of each class of a shard) as PNGs.
Over a plain VAR model it serves class-conditional generation
(`class_conditional`) instead.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Union

import numpy as np
import torch

from controlvar_tpu_torch.config import SampleConfig
from controlvar_tpu_torch.device import DeviceLike, generator_for, resolve_device
from controlvar_tpu_torch.eval.stepwise import (StepwiseCondSampler, StepwiseJointSampler,
                                               StepwiseVARSampler)
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.var import VARModel
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.utils.tracker import span


def class_shard(num_classes: int, shard_id: int, num_shards: int) -> List[int]:
    """Class-range sharding, the last shard taking the remainder
    (the reference's train_control_var_hpu.py:366-368)."""
    per = num_classes // num_shards
    lo = per * shard_id
    hi = num_classes if shard_id == num_shards - 1 else per * (shard_id + 1)
    return list(range(lo, hi))


def _to_uint8_async(img: torch.Tensor) -> torch.Tensor:
    """Canvases in [0, 1] as uint8 on the host, truncated as
    `clip(img * 255, 0, 255).astype(uint8)` in the canvas's own dtype. From
    the card the copy goes to pinned memory without blocking the host: it is
    whole once the stream has passed it (`pipelined_map` waits for that)."""
    u8 = (img * 255.0).clamp(0, 255).to(torch.uint8)
    if not u8.is_cuda:
        return u8
    return torch.empty(u8.shape, dtype=torch.uint8, pin_memory=True).copy_(u8, non_blocking=True)


def _to_uint8(img: torch.Tensor) -> np.ndarray:
    """`_to_uint8_async`, waited for, as a numpy array."""
    host = _to_uint8_async(img)
    if img.is_cuda:
        torch.cuda.current_stream(img.device).synchronize()
    return host.numpy()


@dataclasses.dataclass
class SamplingHarness:
    """Entry point of generation. Runs on `cuda` unless device="cpu" is
    passed.

    sample_cfg.kv_window sends all three samplers to the segmented cache
    mode (K5 on the card); inplace_decode sends their stacked caches through
    K6. decode_generated_only decodes only the generated canvas in the
    conditional modes (the forced stream is the caller's input); the other
    member of the returned pair is then its raw f_hat, not pixels. sampler
    is the route of every draw of the three samplers
    (`ops/sampling.py:METHODS`; "sort" keeps K2 out). A model whose mesh
    has a model axis above 1 takes its samplers tensor parallel, on this
    rank's shard of the params (`eval/stepwise.py`).

    A plain `VARModel` builds one `StepwiseVARSampler` (guidance
    sample_cfg.cfg[0], ramped over the scales) and serves
    `class_conditional` alone; a ControlVAR model builds no VAR sampler."""

    model: Union[ControlVARModel, VARModel]
    vqvae: VQVAE
    sample_cfg: SampleConfig = SampleConfig()
    compute_dtype: torch.dtype = torch.bfloat16
    device: DeviceLike = None
    decode_generated_only: bool = False
    inplace_decode: bool = False
    sampler: str = "auto"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        sc = self.sample_cfg
        common = dict(top_k=sc.top_k, top_p=sc.top_p, more_smooth=sc.more_smooth,
                      inplace_decode=self.inplace_decode, device=self.device,
                      compute_dtype=self.compute_dtype, sampler=self.sampler)
        if sc.kv_window is not None:
            common.update(cache_mode="seg", kv_window=sc.kv_window)
        if self._is_var():
            self._var = StepwiseVARSampler(self.model, self.vqvae, cfg_scale=sc.cfg[0],
                                           **common)
            return
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
        return (self._var if self._is_var() else self._joint).prepare_params(params)

    def _is_var(self) -> bool:
        return isinstance(self.model, VARModel)

    def class_conditional(self, params, vq_params, labels, generator, **kw):
        """Plain-VAR class-conditional CFG generation -> (B, H, W, 3) in
        [0, 1] (the final f_hat with decode_img=False). labels: (B,) class
        ids; generator: a CPU torch.Generator, the source of every draw."""
        if not self._is_var():
            raise TypeError("class_conditional serves a VARModel; a ControlVAR model takes "
                            "joint, control_conditioned or image_conditioned")
        with span("call"):
            return self._var(params, vq_params, labels, generator, **kw)

    def _tokenize(self, vq_params, img):
        with span("tokenize"):
            return self.vqvae.img_to_ids(vq_params, img.to(self.device),
                                         compute_dtype=self.compute_dtype)

    def joint(self, params, vq_params, labels, cond_type, generator, **kw):
        """Joint (control, image) generation -> two (B, H, W, 3) in [0, 1]."""
        with span("call"):
            return self._joint(params, vq_params, labels, cond_type, generator, **kw)

    def control_conditioned(self, params, vq_params, labels, cond_type, generator,
                            control_imgs, **kw):
        """Teacher-force the control stream from control images (B,H,W,3) in [-1,1]."""
        with span("call"):
            c_mask = self._tokenize(vq_params, control_imgs)
            return self._cond_mask(params, vq_params, labels, cond_type, generator, c_mask,
                                   **kw)

    def image_conditioned(self, params, vq_params, labels, cond_type, generator,
                          imgs, **kw):
        """Teacher-force the image stream (control prediction mode)."""
        with span("call"):
            c_img = self._tokenize(vq_params, imgs)
            return self._cond_img(params, vq_params, labels, cond_type, generator, c_img,
                                  **kw)

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

    # ---- FID-protocol generation --------------------------------------------

    def generate_fid_set(self, params, vq_params, out_dir: str, batch_size: int = 25,
                         images_per_class: int = 50, num_classes: int = 1000,
                         shard_id: int = 0, num_shards: int = 1,
                         cond_type_id: int = 2,  # 'depth' (the reference's :374)
                         seed: int = 42, gibbs: int = 0) -> int:
        """Write {out_dir}/{cls}/{i}.png for the classes of this shard;
        returns the image count.

        Each batch draws from generator_for(seed + cls * 1000 + made), so an
        image does not depend on how the classes were sharded. Batches run
        through `pipelined_map` (eval/serving.py): the PNGs of batch i are
        written while the device finishes batch i+1. PNGs are written with
        zlib (`utils/tracker.py:write_png`)."""
        from controlvar_tpu_torch.eval.serving import pipelined_map
        from controlvar_tpu_torch.utils.tracker import write_png

        def work_items():
            for cls in class_shard(num_classes, shard_id, num_shards):
                os.makedirs(os.path.join(out_dir, str(cls)), exist_ok=True)
                made = 0
                while made < images_per_class:
                    B = min(batch_size, images_per_class - made)
                    yield cls, made, B
                    made += B

        def generate(item):
            cls, made, B = item
            labels = torch.full((B,), cls, dtype=torch.long)
            ct = torch.full((B,), cond_type_id, dtype=torch.long)
            g = generator_for(seed + cls * 1000 + made)
            img_c, img_i = self.joint(params, vq_params, labels, ct, g)
            if gibbs:
                img_c, img_i = self.gibbs_refine(params, vq_params, labels, ct, g,
                                                 img_c, img_i, gibbs)
            return _to_uint8_async(img_i)

        count = 0
        for (cls, made, B), arr in pipelined_map(generate, work_items()):
            arr = arr.numpy()
            for b in range(B):
                write_png(os.path.join(out_dir, str(cls), f"{made + b}.png"), arr[b])
            count += B
        return count
