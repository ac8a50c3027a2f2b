"""ControlVAR: joint control+image next-scale AR transformer (parameters,
embedding helpers, the teacher-forced training forward, and joint sampling
in the `replace` and `separate_decoding` modes; the conditional and the
interleaved joint samplers are eval/stepwise.py).

Every scale holds an interleaved pair (control_k, image_k); the first scale
is the pair (cond-type embedding, class embedding). A `replace` model
(mask_factor 1) holds one pn^2 segment a scale.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from controlvar_tpu_torch.config import COND_UNCOND_ID, ControlVARConfig
from controlvar_tpu_torch.device import (DeviceLike, generator_for,
                                        resolve_device, tree_to)
from controlvar_tpu_torch.models import transformer as tfm
from controlvar_tpu_torch.models.masks import attn_mask_for_config, level_index_1L
from controlvar_tpu_torch.ops.attention import tile_flags
from controlvar_tpu_torch.ops.resize import resize_area
from controlvar_tpu_torch.ops.sampling import (gumbel_softmax, sample_top_k_top_p,
                                               smooth_temperature)

Params = Dict


class ControlVARModel:
    """Model entry point. Runs on `cuda` unless device="cpu" is passed."""

    def __init__(self, cfg: ControlVARConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        lvl = level_index_1L(cfg.patch_nums, cfg.mask_factor, cfg.separator)
        # the (L,) scale index of every token, copied to the device once
        self._level_index = torch.from_numpy(lvl).long().to(self.device)
        # the (L, L) training attention mask, copied to the device once, and
        # the flags of its 64 x 64 tiles that the attention kernels read
        self._attn_mask = torch.tensor(attn_mask_for_config(cfg), device=self.device)
        self._tile_flags = tile_flags(self._attn_mask)

    def init_params(self, seed: int) -> Params:
        """Reference-default initialized fp32 params from a seed, on self.device."""
        cfg = self.cfg
        if cfg.separator or cfg.type_pos or cfg.shared_aln:
            raise NotImplementedError("separator/type_pos/shared_aln are not ported yet")
        g = generator_for(seed)
        C = cfg.embed_dim
        init_std = float(np.sqrt(1.0 / C / 3.0))
        p: Params = {
            "word_embed": {"kernel": tfm._trunc_normal(g, (cfg.cvae, C), 0.02),
                           "bias": torch.zeros(C)},
            "class_emb": tfm._trunc_normal(g, (cfg.num_classes + 1, C), init_std),
            "pos_start": tfm._trunc_normal(g, (1, cfg.first_l, C), init_std),
            "pos_1LC": tfm._trunc_normal(g, (1, cfg.seq_len, C), init_std),
            "lvl_embed": tfm._trunc_normal(g, (cfg.num_scales, C), init_std),
            "blocks": tfm.init_block_params(g, cfg),
        }
        p.update(tfm.init_head_params(g, cfg, cfg.head_vocab))
        if cfg.multi_cond:
            p["cond_embed"] = tfm._trunc_normal(g, (cfg.num_cond_types, C), init_std)
        return tree_to(p, self.device)

    def _lvl_pos(self, params: Params) -> torch.Tensor:
        """(1, L, C) level embedding + absolute position of every token."""
        lvl = self._level_index.to(params["lvl_embed"].device)
        return params["lvl_embed"][lvl][None] + params["pos_1LC"]

    def _word_embed(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ params["word_embed"]["kernel"] + params["word_embed"]["bias"]

    def _sos(self, params: Params, labels: torch.Tensor,
             cond_type: Optional[torch.Tensor], mask_first: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cond (N, C), sos (N, first_l, C)) without pos_start: the pair
        [cond-type embedding, class embedding] for multi_cond (swapped when
        not mask_first), else the class embedding repeated."""
        cfg = self.cfg
        cond = params["class_emb"][labels]
        if cfg.multi_cond and cfg.mask_factor == 2:
            ct = params["cond_embed"][cond_type]
            pair = [ct, cond] if mask_first else [cond, ct]
            return cond, torch.stack(pair, dim=1)
        return cond, cond[:, None, :].expand(-1, cfg.first_l, -1)

    def _drop_cond(self, labels: torch.Tensor, cond_type: Optional[torch.Tensor],
                   generator: torch.Generator):
        """Classifier-free-guidance training drop: each class id becomes the
        unconditional id num_classes, and each cond type COND_UNCOND_ID,
        independently with probability cond_drop_rate."""
        cfg = self.cfg
        u = torch.rand(2, labels.shape[0], generator=generator).to(labels.device)
        labels = torch.where(u[0] < cfg.cond_drop_rate, cfg.num_classes, labels)
        if cfg.multi_cond and cond_type is not None:
            cond_type = torch.where(u[1] < cfg.cond_drop_rate, COND_UNCOND_ID, cond_type)
        return labels, cond_type

    def forward_train(self, params: Params, labels: torch.Tensor, x_tf: torch.Tensor,
                      cond_type: Optional[torch.Tensor] = None, mask_first: bool = True,
                      generator: Optional[torch.Generator] = None, train: bool = True,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
        """Teacher-forced logits (B, L, head_vocab) fp32.

        labels (B,) class ids; x_tf (B, L - first_l, Cvae) interleaved
        teacher-forcing features; cond_type (B,) for multi_cond. With train
        and a generator, the class (and cond type) is dropped to the
        unconditional id with probability cond_drop_rate, and drop path is
        drawn from the same generator; with train, every layer is recomputed
        in the backward. The residual stream runs in compute_dtype: bf16 on
        the GPU, where attention goes through K3/K4.
        """
        cfg = self.cfg
        if cfg.separator or cfg.type_pos or cfg.shared_aln or cfg.bidirectional:
            raise NotImplementedError(
                "separator/type_pos/shared_aln/bidirectional training is not ported yet")
        if train and generator is not None:
            labels, cond_type = self._drop_cond(labels, cond_type, generator)
        cond, sos = self._sos(params, labels, cond_type, mask_first)
        x = torch.cat([sos + params["pos_start"], self._word_embed(params, x_tf)], dim=1)
        x = x + self._lvl_pos(params)
        x = tfm.blocks_forward(params["blocks"], x.to(compute_dtype), cond, cfg,
                               self._attn_mask.to(x.device),
                               flags=self._tile_flags.to(x.device), train=train,
                               generator=generator)
        return tfm.head_logits(params, x, cond, cfg)

    # ---- joint sampling ------------------------------------------------------

    def sample_joint_cfg(self, params: Params, vqvae, vq_params: Params, labels: torch.Tensor,
                         cond_type: Optional[torch.Tensor], generator: torch.Generator,
                         cfg_scale: float = 4.0, top_k: int = 900, top_p: float = 0.96,
                         compute_dtype: torch.dtype = torch.bfloat16, decode_img: bool = True,
                         more_smooth: bool = False, mask_first: bool = True):
        """Joint (control, image) CFG generation (the JAX package's
        `sample_joint_cfg`): a mask_factor 2 model runs
        `StepwiseJointSampler` and returns the (control, image) canvases; a
        mask_factor 1 ("replace") model runs the single-stream sampler and
        returns ONE canvas. Canvases are (B, H, W, 3) in [0, 1], or the
        f_hats with decode_img=False. generator: a CPU torch.Generator, the
        source of every draw."""
        if self.cfg.mask_factor == 1:
            return self._sample_replace_cfg(params, vqvae, vq_params, labels, generator,
                                            cfg_scale, top_k, top_p, compute_dtype, decode_img,
                                            more_smooth)
        from controlvar_tpu_torch.eval.stepwise import StepwiseJointSampler

        sampler = StepwiseJointSampler(self, vqvae, cfg_scale=cfg_scale, top_k=top_k,
                                       top_p=top_p, mask_first=mask_first,
                                       more_smooth=more_smooth, device=self.device,
                                       compute_dtype=compute_dtype)
        return sampler(params, vq_params, labels, cond_type, generator, decode_img=decode_img)

    def _draw(self, params, vq_params, vqvae, x, cond, si, cfg_scale, top_k, top_p,
              more_smooth, generator, l):
        """Scale si's CFG head and draw: the (B, l, Cvae) embeddings of the
        first l drawn tokens (gumbel-softmax ones with more_smooth)."""
        SN = self.cfg.num_scales
        t = cfg_scale * si / (SN - 1)
        logits = tfm.head_logits_cfg(params, x, cond, self.cfg, (1.0 + t, -t))
        logits = logits[:, :, : self.cfg.vocab_size]
        ids = sample_top_k_top_p(logits, top_k, top_p, generator)
        if more_smooth:
            factor, tau = smooth_temperature(si, SN)
            soft = gumbel_softmax(logits[:, :l] * factor, tau, generator=generator)
            return soft @ vq_params["quantize"]["embedding"].float()
        return vqvae.quantizer.embed(vq_params["quantize"], ids[:, :l])

    @torch.no_grad()
    def _sample_replace_cfg(self, params, vqvae, vq_params, labels, generator, cfg_scale,
                            top_k, top_p, compute_dtype, decode_img, more_smooth):
        """mask_factor 1 ("replace") CFG sampling (the JAX package's
        `_sample_replace_cfg`): one token stream and one canvas a sample,
        pn^2 tokens a scale, the class embedding as SOS (first_l == 1), the
        `indep` mask slice where the config has one. Separator models are
        rejected, as there."""
        cfg = self.cfg
        if cfg.separator:
            raise ValueError("separator is mask_factor 2 only")
        pns, SN, z = cfg.patch_nums, cfg.num_scales, vqvae.cfg.z_channels
        B = labels.shape[0]
        labels = labels.to(self.device)
        cond = params["class_emb"][torch.cat([labels, torch.full_like(labels, cfg.num_classes)])]
        lvl_pos = self._lvl_pos(params)
        next_map = cond[:, None, :] + params["pos_start"] + lvl_pos[:, : cfg.first_l]
        cache_k, cache_v = tfm.init_kv_cache(cfg, 2 * B, cfg.seq_len, compute_dtype,
                                             self.device)
        fh = torch.zeros(B, pns[-1], pns[-1], z, device=self.device)
        for si, pn in enumerate(pns):
            lo, hi = cfg.begin_ends[si]
            mask_slice = self._attn_mask[lo:hi, :hi] if cfg.indep else None
            x, cache_k, cache_v = tfm.blocks_decode(params["blocks"], next_map.to(compute_dtype),
                                                    cond, cfg, cache_k, cache_v, lo,
                                                    mask_slice=mask_slice)
            h = self._draw(params, vq_params, vqvae, x, cond, si, cfg_scale, top_k,
                           top_p, more_smooth, generator, pn * pn)
            fh, nxt = vqvae.quantizer.next_ar_input(vq_params["quantize"], si, fh,
                                                    h.reshape(B, pn, pn, z))
            if si != SN - 1:
                lo, hi = cfg.begin_ends[si + 1]
                nm = self._word_embed(params, nxt.reshape(B, hi - lo, z)) + lvl_pos[:, lo:hi]
                next_map = nm.repeat(2, 1, 1)
        if not decode_img:
            return fh
        return (vqvae.fhat_to_img(vq_params, fh, compute_dtype) + 1.0) * 0.5

    @torch.no_grad()
    def sample_joint_separate(self, params: Params, vqvae, vq_params: Params,
                              labels: torch.Tensor, cond_type: torch.Tensor,
                              generator: torch.Generator, cfg_scale: float = 4.0,
                              top_k: int = 900, top_p: float = 0.96,
                              compute_dtype: torch.dtype = torch.bfloat16,
                              decode_img: bool = True, more_smooth: bool = False,
                              mask_first: bool = True):
        """`separate_decoding` (non-indep) joint generation (the JAX
        package's `sample_joint_separate`): the control and image segments of
        each scale are decoded one after the other, 2S transformer calls over
        one stacked cache. The control segment of scale k updates its canvas;
        the image segment's input is that canvas area-resized to the same
        scale; the image segment updates the image canvas, whose next-scale
        input feeds scale k+1's control segment. Returns the (control,
        image) canvases as `sample_joint_cfg` does."""
        cfg = self.cfg
        if not cfg.separate_decoding or cfg.indep:
            raise ValueError("sample_joint_separate needs separate_decoding without indep")
        if cfg.mask_factor != 2 or not cfg.multi_cond:
            raise ValueError("sample_joint_separate needs mask_factor=2 and multi_cond")
        if cfg.type_pos:
            raise ValueError("type_pos separate decoding is broken in the reference")
        if cfg.separator:
            raise NotImplementedError("separator sampling is not ported yet")
        pns, SN, z = cfg.patch_nums, cfg.num_scales, vqvae.cfg.z_channels
        B = labels.shape[0]
        labels, cond_type = labels.to(self.device), cond_type.to(self.device)
        cond = params["class_emb"][torch.cat([labels, torch.full_like(labels, cfg.num_classes)])]
        ct_tok = params["cond_embed"][
            torch.cat([cond_type, torch.full_like(cond_type, COND_UNCOND_ID)])]
        lvl_pos = self._lvl_pos(params)
        pair = [ct_tok, cond] if mask_first else [cond, ct_tok]
        first = torch.stack(pair, dim=1) + params["pos_start"] + lvl_pos[:, : cfg.first_l]
        x_next = first[:, : pns[0] ** 2]
        cache_k, cache_v = tfm.init_kv_cache(cfg, 2 * B, cfg.seq_len, compute_dtype,
                                             self.device)
        fh_1 = torch.zeros(B, pns[-1], pns[-1], z, device=self.device)
        fh_2 = torch.zeros_like(fh_1)
        cur = 0
        for si in range(2 * SN):
            sc = si // 2
            pn = pns[sc]
            x, cache_k, cache_v = tfm.blocks_decode(params["blocks"], x_next.to(compute_dtype),
                                                    cond, cfg, cache_k, cache_v, cur)
            h = self._draw(params, vq_params, vqvae, x, cond, sc, cfg_scale, top_k,
                           top_p, more_smooth, generator, pn * pn).reshape(B, pn, pn, z)
            cur += pn * pn
            if si % 2 == 0:  # control segment: the image input at the same scale
                fh_1, _ = vqvae.quantizer.next_ar_input(vq_params["quantize"], sc, fh_1, h)
                nxt = resize_area(fh_1, pn, pn)
            else:            # image segment: the next scale's control input
                fh_2, nxt = vqvae.quantizer.next_ar_input(vq_params["quantize"], sc, fh_2, h)
            if si == 0:
                x_next = first[:, pns[0] ** 2:]
            elif si != 2 * SN - 1:
                nl = pns[(si + 1) // 2] ** 2
                nm = self._word_embed(params, nxt.reshape(B, nl, z)) + lvl_pos[:, cur: cur + nl]
                x_next = nm.repeat(2, 1, 1)
        if not mask_first:
            fh_1, fh_2 = fh_2, fh_1
        if not decode_img:
            return fh_1, fh_2
        both = (vqvae.fhat_to_img(vq_params, torch.cat([fh_1, fh_2]), compute_dtype) + 1.0) * 0.5
        return both[:B], both[B:]
