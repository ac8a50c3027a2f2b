"""Teacher-forced conditional ControlVAR sampler (multi-scale CFG).

Port of `controlvar_tpu/eval/stepwise.py:StepwiseCondSampler`. The JAX
package compiles one jit per group of scales; here the scales are a plain
Python loop over eager PyTorch ops and the two kernels (K1 decode attention
in every layer, K2 bisection sampling once per scale).

Per call: prologue (class and cond-type embeddings, SOS pair), then for each
scale: `blocks_decode` over the R CFG branches, the CFG-combined head, one
draw of the free tokens, the teacher-forced ids spliced in, the residual
canvas update of both streams and the next scale's input map; then the
VQVAE decode of the canvases.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from controlvar_tpu_torch.config import COND_UNCOND_ID
from controlvar_tpu_torch.device import DeviceLike, resolve_device, tree_to
from controlvar_tpu_torch.models import transformer as tfm
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.masks import attn_mask_for_config
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.ops.sampling import sample_top_k_top_p

Params = Dict


class _PrepareParamsMixin:
    compute_dtype: torch.dtype = torch.bfloat16

    def prepare_params(self, params: Params) -> Params:
        """Cast the block weights to the compute dtype once; embeddings and
        the head stay fp32."""
        out = dict(params)
        out["blocks"] = tree_to(params["blocks"], params["blocks"]["q_bias"].device,
                                self.compute_dtype)
        return out


@dataclasses.dataclass
class StepwiseCondSampler(_PrepareParamsMixin):
    """Conditional generation with one stream teacher-forced: the control
    stream for force="control", the image stream for force="image". Two
    token-stream groups [forced (B) | uncond (B)] share the forced copies;
    only the transformer runs all `repeat_num` CFG branches."""

    model: ControlVARModel
    vqvae: VQVAE
    cfg_scales: Tuple[float, float, float] = (4.0, 4.0, 4.0)
    top_k: int = 900
    top_p: float = 0.96
    force: str = "control"
    repeat_num: int = 4     # CFG branches: 4 or 3
    decode: str = "both"    # "both", or only the generated "image"/"control"
    device: DeviceLike = None
    compute_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        cfg = self.model.cfg
        if cfg.mask_factor != 2 or cfg.separator or cfg.type_pos:
            raise ValueError("conditional sampling needs mask_factor=2 and no "
                             "separator/type_pos")
        if (self.repeat_num not in (3, 4) or self.force not in ("control", "image")
                or self.decode not in ("both", "image", "control")):
            raise ValueError(f"unsupported repeat_num={self.repeat_num}, "
                             f"force={self.force!r} or decode={self.decode!r}")
        self.device = resolve_device(self.device)
        self.quant = self.vqvae.quantizer
        self._full_mask = None
        if cfg.indep:
            self._full_mask = torch.from_numpy(attn_mask_for_config(cfg)).to(self.device)

    # -- pieces ---------------------------------------------------------------

    def _prologue(self, params, labels, cond_type):
        cfg = self.model.cfg
        R = self.repeat_num
        null = torch.full_like(labels, cfg.num_classes)
        labels_r = torch.cat([labels] + [null] * (R - 1))
        unc = torch.full_like(cond_type, COND_UNCOND_ID)
        ct_r = torch.cat([cond_type, cond_type] + [unc] * (R - 2))
        cond = params["class_emb"][labels_r]
        ct_tok = params["cond_embed"][ct_r]
        lvl_pos = self.model._lvl_pos(params)
        next_map = (torch.stack([ct_tok, cond], dim=1) + params["pos_start"]
                    + lvl_pos[:, : cfg.first_l])
        return cond, next_map

    def _step_fn(self, si, params, vq_params, cond, next_map, cache_k, cache_v,
                 fh_c, fh_i, generator, forced):
        cfg = self.model.cfg
        pns = cfg.patch_nums
        SN = cfg.num_scales
        pn = pns[si]
        seg = cfg.scale_seg_len(si)
        cur = cfg.begin_ends[si][0]
        R = self.repeat_num
        B = next_map.shape[0] // R
        z = self.vqvae.cfg.z_channels

        mask_slice = None
        if self._full_mask is not None:
            mask_slice = self._full_mask[cur: cur + seg, : cur + seg]
        x, cache_k, cache_v = tfm.blocks_decode(
            params["blocks"], next_map.to(self.compute_dtype), cond, cfg,
            cache_k, cache_v, cur, mask_slice=mask_slice)
        t1, t2, t3 = (c * si / (SN - 1) for c in self.cfg_scales)
        # multi-scale CFG combined before the head matmul (weights sum to 1)
        w = ((1.0 + t1, t2 - t1, t3 - t2, -t3) if R == 4
             else (1.0 + t1, t2 - t1, -t2))
        combined = tfm.head_logits_cfg(params, x, cond, cfg, w)[:, :, : cfg.vocab_size]
        l = pn * pn
        # draw [forced group's free half | uncond group's both halves]
        if self.force == "control":
            sample_in = torch.cat([combined[:, l:], combined], dim=1)
        else:
            sample_in = torch.cat([combined[:, :l], combined], dim=1)
        out = sample_top_k_top_p(sample_in, self.top_k, self.top_p, generator)
        a_sampled, b_ids = out[:, :l], out[:, l:]
        if self.force == "control":
            ids_a = torch.cat([forced, a_sampled], dim=1)
        else:
            ids_a = torch.cat([a_sampled, forced], dim=1)
        ids = torch.cat([ids_a, b_ids], dim=0)                    # (2B, 2l)
        h_c = self.quant.embed(vq_params["quantize"], ids[:, :l]).reshape(2 * B, pn, pn, z)
        h_i = self.quant.embed(vq_params["quantize"], ids[:, l:]).reshape(2 * B, pn, pn, z)
        fh_c, nxt_c = self.quant.next_ar_input(vq_params["quantize"], si, fh_c, h_c)
        fh_i, nxt_i = self.quant.next_ar_input(vq_params["quantize"], si, fh_i, h_i)
        if si != SN - 1:
            nl = pns[si + 1] ** 2
            nm_c = self.model._word_embed(params, nxt_c.reshape(2 * B, nl, z))
            nm_i = self.model._word_embed(params, nxt_i.reshape(2 * B, nl, z))
            nm = torch.cat([nm_c, nm_i], dim=1)
            nxt_cur = cfg.begin_ends[si + 1][0]
            nm = nm + self.model._lvl_pos(params)[:, nxt_cur: nxt_cur + cfg.scale_seg_len(si + 1)]
            next_map = torch.cat([nm[:B].repeat(R - 1, 1, 1), nm[B:]], dim=0)
        return next_map, cache_k, cache_v, fh_c, fh_i

    def _epilogue(self, vq_params, fh_c, fh_i):
        B = fh_c.shape[0] // 2
        dec = lambda fh: (self.vqvae.fhat_to_img(vq_params, fh, self.compute_dtype) + 1.0) * 0.5
        if self.decode == "image":
            return fh_c[:B], dec(fh_i[:B])
        if self.decode == "control":
            return dec(fh_c[:B]), fh_i[:B]
        both = dec(torch.cat([fh_c[:B], fh_i[:B]], dim=0))
        return both[:B], both[B:]

    # -- run -------------------------------------------------------------------

    @torch.no_grad()
    def __call__(self, params, vq_params, labels, cond_type, generator: torch.Generator,
                 forced_ids: Sequence[torch.Tensor], decode_img: bool = True):
        """forced_ids: per-scale (B, pn^2) ids of the forced stream (control
        when force="control", image when force="image"). generator: a CPU
        torch.Generator, the source of every draw. Returns the (control,
        image) canvases in [0, 1], or the f_hats with decode_img=False."""
        cfg = self.model.cfg
        B = labels.shape[0]
        pns = cfg.patch_nums
        z = self.vqvae.cfg.z_channels
        labels = labels.to(self.device)
        cond_type = cond_type.to(self.device)
        cond, next_map = self._prologue(params, labels, cond_type)
        cache_k, cache_v = tfm.init_kv_cache(cfg, self.repeat_num * B, cfg.seq_len,
                                             self.compute_dtype, self.device)
        fh_c = torch.zeros(2 * B, pns[-1], pns[-1], z, device=self.device)
        fh_i = torch.zeros(2 * B, pns[-1], pns[-1], z, device=self.device)
        for si in range(cfg.num_scales):
            next_map, cache_k, cache_v, fh_c, fh_i = self._step_fn(
                si, params, vq_params, cond, next_map, cache_k, cache_v,
                fh_c, fh_i, generator, forced_ids[si].to(self.device))
        if not decode_img:
            return fh_c[:B], fh_i[:B]
        return self._epilogue(vq_params, fh_c, fh_i)
