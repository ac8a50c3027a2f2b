"""Step-wise samplers: ControlVAR joint (control, image) generation, the
ControlVAR teacher-forced conditional sampler (multi-scale CFG), and plain
VAR class-conditional generation.

Port of `controlvar_tpu/eval/stepwise.py:StepwiseJointSampler`,
`StepwiseCondSampler` and `StepwiseVARSampler`. The JAX package compiles
one jit per group of scales; here the scales are a plain Python loop over
eager PyTorch ops and the kernels: K2 bisection sampling once per scale,
and in every layer the attention of the cache's layout: K1 (the paired
stacked cache, written then read), K6 (the paired stacked cache,
`inplace_decode`: one fused write-and-attend launch), K7 (the flat layout
of configs with hd != 64 or an odd head count), K8 (the fused cache,
`kv_fused`) or, in the segmented cache mode, K1 at scale 0 and K5 after it.

Per call: prologue (class and cond-type embeddings, SOS), then for each
scale: the blocks over all CFG rows, the CFG-combined head, one draw, the
residual canvas update and the next scale's input map; then the VQVAE
decode of the canvases. Each of these opens its span (`utils/tracker.py:
span`): cv/prologue, cv/scale/<si> holding cv/blocks, cv/head, cv/draw and
cv/canvas, then cv/decode.

Cache modes: "stacked" preallocates the caches of `init_kv_cache`; "seg"
keeps one (depth, rows, H, l_s, hd) segment per scale, and with
`kv_window` w only the first segment and the last w (a lossy accelerant,
the JAX package's `--kv_window`). As in the JAX package, "seg" quietly
becomes "stacked" when `kv_layout` is not "paired". The JAX package's
`CONTROLVAR_INPLACE_DECODE` and `CONTROLVAR_KV_FUSED` env switches are the
`inplace_decode` and `kv_fused` arguments, for the stacked mode of a paired
layout; where the JAX package ignores a switch, the port raises. Its
`groups` (a grouping of jits) has no counterpart.

`sampler` is the route of every draw (`ops/sampling.py:METHODS`): "auto"
and the bisect names take K2 on the card, "sort" the sort route. The JAX
package sets it for a whole process (`ops/sampling.py:DEFAULT_METHOD`); here
each sampler takes it as an argument.

A ControlVAR model whose mesh has a model axis above 1 runs the samplers
tensor parallel on this rank's shard of the params: the
stacked cache holds the shard's heads, the logits are gathered whole, and
each scale's ids are model rank 0's draw, broadcast over the model group
(every rank draws, so that the generators stay in step). The VQVAE stays
whole on every rank. The segmented cache (`kv_window`), in-place decode,
the flat and fused layouts and the plain-VAR sampler raise
NotImplementedError there: no JAX entry point runs them on a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from controlvar_tpu_torch.config import COND_UNCOND_ID
from controlvar_tpu_torch.device import DeviceLike, resolve_device, tree_to
from controlvar_tpu_torch.models import transformer as tfm
from controlvar_tpu_torch.models.control_var import ControlVARModel, tp_draw
from controlvar_tpu_torch.models.masks import attn_mask_for_config
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.ops.sampling import (METHODS, gumbel_softmax,
                                               sample_top_k_top_p, smooth_temperature)
from controlvar_tpu_torch.utils.tracker import span

Params = Dict


def _windowed_segs(segs_k, segs_v, w):
    """Scale-aware KV window over per-scale cache segments: keep the first
    segment (SOS and scale 0, the anchor every later scale attends to) and
    the last `w`, dropping the middle; the identity while the prefix is
    short or w is None."""
    if w is None or len(segs_k) <= w + 1:
        return segs_k, segs_v
    return segs_k[:1] + segs_k[-w:], segs_v[:1] + segs_v[-w:]


class _SamplerBase:
    """What the samplers share: the bf16 weight cast, the cache modes and
    the `indep` mask."""

    model: object  # ControlVARModel or VARModel
    vqvae: VQVAE
    cache_mode: str
    kv_window: Optional[int]
    inplace_decode: bool
    kv_fused: bool
    device: DeviceLike
    compute_dtype: torch.dtype
    sampler: str

    def _setup(self):
        """The ControlVAR samplers' checks, their `indep` mask, then the
        cache-mode guards."""
        cfg = self.model.cfg
        if cfg.mask_factor != 2:
            raise ValueError("ControlVAR sampling needs mask_factor=2")
        self.device = resolve_device(self.device)
        self._full_mask = None
        if cfg.indep:
            self._full_mask = torch.from_numpy(attn_mask_for_config(cfg)).to(self.device)
        self._setup_caches()

    def _setup_caches(self):
        """The cache-mode guards. Where the JAX package quietly ignores
        `CONTROLVAR_KV_FUSED=1` (the segmented mode, in-place decode, a flat
        layout), `kv_fused` raises. A tensor-parallel model takes the
        stacked cache of the paired layout alone."""
        cfg = self.model.cfg
        self.device = resolve_device(self.device)
        self.quant = self.vqvae.quantizer
        self._tp = getattr(self.model, "tp", None)  # a VARModel refuses a model axis
        if self._tp is not None:
            if (self.cache_mode != "stacked" or self.inplace_decode or self.kv_fused
                    or tfm.kv_layout(cfg) != "paired"):
                raise NotImplementedError(
                    "tensor parallelism takes the stacked cache of the paired layout: the "
                    "segmented cache (kv_window), in-place decode and the flat and fused "
                    "layouts run on one device (no JAX entry point runs them on a mesh)")
        if self.sampler not in METHODS:
            raise ValueError(f"unknown sampler {self.sampler!r}; use one of {METHODS}")
        if self.cache_mode not in ("stacked", "seg"):
            raise ValueError(f"unknown cache_mode {self.cache_mode!r}")
        if self.kv_fused:
            if self.cache_mode != "stacked" or self.inplace_decode:
                raise ValueError("kv_fused applies to cache_mode='stacked' without "
                                 "inplace_decode")
            if tfm.kv_layout(cfg) != "paired":
                raise ValueError("kv_fused needs the paired KV layout (hd = 64, an even "
                                 "head count)")
        if self.cache_mode == "seg" and tfm.kv_layout(cfg) != "paired":
            self.cache_mode = "stacked"
        if self.kv_window is not None:
            if self.cache_mode != "seg":
                raise ValueError("kv_window requires cache_mode='seg' (paired KV layout)")
            if self._full_mask is not None:
                raise ValueError("kv_window is unsupported with indep masking (mask "
                                 "columns index the full prefix)")
        if self.inplace_decode:
            if self.cache_mode != "stacked":
                raise ValueError("inplace_decode applies to cache_mode='stacked'")
            if tfm.kv_layout(cfg) != "paired":
                raise ValueError("inplace_decode needs the paired KV layout (hd = 64, an "
                                 "even head count)")

    def prepare_params(self, params: Params) -> Params:
        """Cast the block weights to the compute dtype once; embeddings and
        the head stay fp32."""
        out = dict(params)
        out["blocks"] = tree_to(params["blocks"], params["blocks"]["q_bias"].device,
                                self.compute_dtype)
        return out

    def _init_caches(self, rows: int, params=None):
        """The caches of `rows` rows, for the heads of params' blocks (a
        tensor-parallel shard's) or of the config."""
        if self.cache_mode == "seg":
            return (), ()
        cfg = self.model.cfg
        heads = None if params is None else tfm.local_heads(params["blocks"], cfg)
        return tfm.init_kv_cache(cfg, rows, cfg.seq_len, self.compute_dtype, self.device,
                                 fused=self.kv_fused, heads=heads)

    def _draw(self, logits, generator):
        """The ids of one scale's draw (model rank 0's under tensor
        parallelism)."""
        with span("draw"):
            return tp_draw(sample_top_k_top_p(logits, self.top_k, self.top_p, generator,
                                              method=self.sampler), self._tp)

    def _head(self, params, x, cond, weights):
        """The CFG-combined logits of the vocabulary."""
        cfg = self.model.cfg
        with span("head"):
            return tfm.head_logits_cfg(params, x, cond, cfg, weights,
                                       self._tp)[:, :, : cfg.vocab_size]

    def _blocks(self, params, si, next_map, cond, cache_k, cache_v):
        """The blocks over scale si's input map in the cache mode; returns
        (hidden states, caches)."""
        with span("blocks"):
            cfg = self.model.cfg
            cur, hi = cfg.begin_ends[si]
            mask_slice = None if self._full_mask is None else self._full_mask[cur:hi, :hi]
            x = next_map.to(self.compute_dtype)
            if self.cache_mode == "seg":
                sk, sv = _windowed_segs(cache_k, cache_v, self.kv_window)
                x, k_new, v_new = tfm.blocks_decode_seg(
                    params["blocks"], x, cond, cfg, sk, sv, mask_slice=mask_slice,
                    shared_lin=params.get("shared_ada_lin"))
                return x, cache_k + (k_new,), cache_v + (v_new,)
            return tfm.blocks_decode(params["blocks"], x, cond, cfg, cache_k, cache_v, cur,
                                     mask_slice=mask_slice, inplace=self.inplace_decode,
                                     shared_lin=params.get("shared_ada_lin"), tp=self._tp)

    def _decode(self, vq_params, fh):
        with span("decode"):
            return (self.vqvae.fhat_to_img(vq_params, fh, self.compute_dtype) + 1.0) * 0.5


@dataclasses.dataclass
class StepwiseJointSampler(_SamplerBase):
    """Joint (control, image) CFG generation: two CFG branches [cond |
    uncond] over B rows each, both streams drawn.

    mask_first: the stream order of bidirectional models (the control
    stream first when True). The returned canvases are always (control,
    image). A separator model's scales after the first are [control,
    separator, image, separator]: the separators' embeddings are spliced
    into the next scale's input and their drawn ids dropped (the logits are
    cut to vocab_size before the draw). A type_pos model adds its type
    embeddings to the input of every scale after the first, as the JAX
    package does."""

    model: ControlVARModel
    vqvae: VQVAE
    cfg_scale: float = 4.0
    top_k: int = 900
    top_p: float = 0.96
    mask_first: bool = True
    more_smooth: bool = False
    cache_mode: str = "stacked"
    kv_window: Optional[int] = None
    inplace_decode: bool = False
    kv_fused: bool = False
    device: DeviceLike = None
    compute_dtype: torch.dtype = torch.bfloat16
    sampler: str = "auto"

    def __post_init__(self):
        self._setup()

    def _prologue(self, params, labels, cond_type):
        cfg = self.model.cfg
        labels2 = torch.cat([labels, torch.full_like(labels, cfg.num_classes)])
        cond = params["class_emb"][labels2]
        lvl_pos = self.model._lvl_pos(params)[:, : cfg.first_l]
        if cfg.multi_cond:
            ct2 = torch.cat([cond_type, torch.full_like(cond_type, COND_UNCOND_ID)])
            ct_tok = params["cond_embed"][ct2]
            pair = [ct_tok, cond] if self.mask_first else [cond, ct_tok]
            return cond, torch.stack(pair, dim=1) + params["pos_start"] + lvl_pos
        sos = cond[:, None, :] + params["pos_start"]
        if cfg.bidirectional:
            # the training side's sign convention for the two SOS halves
            sign = -1.0 if self.mask_first else 1.0
            half = cfg.first_l // 2
            with span("wait"):  # a blocking copy from the host
                ch = torch.tensor([sign] * half + [-sign] * half, device=sos.device)
            sos = sos * ch[None, :, None]
        return cond, sos + lvl_pos

    def _step(self, si, params, vq_params, cond, next_map, cache_k, cache_v, fh_c, fh_i,
              generator):
        cfg = self.model.cfg
        pns, SN = cfg.patch_nums, cfg.num_scales
        pn = pns[si]
        B = next_map.shape[0] // 2
        z = self.vqvae.cfg.z_channels
        x, cache_k, cache_v = self._blocks(params, si, next_map, cond, cache_k, cache_v)
        t = self.cfg_scale * si / (SN - 1)
        logits = self._head(params, x, cond, (1.0 + t, -t))
        ids = self._draw(logits, generator)
        with span("canvas"):
            l = pn * pn
            # the image tokens sit at [l + num_sp, 2l + num_sp)
            num_sp = 1 if (cfg.separator and si > 0) else 0
            img = slice(l + num_sp, 2 * l + num_sp)
            if self.more_smooth:  # gumbel soft embeddings of both streams
                factor, tau = smooth_temperature(si, SN)
                soft = gumbel_softmax(logits * factor, tau, generator=generator)
                h_all = soft @ vq_params["quantize"]["embedding"].float()
                h_c, h_i = h_all[:, :l], h_all[:, img]
            else:
                h_c = self.quant.embed(vq_params["quantize"], ids[:, :l])
                h_i = self.quant.embed(vq_params["quantize"], ids[:, img])
            fh_c, nxt_c = self.quant.next_ar_input(vq_params["quantize"], si, fh_c,
                                                   h_c.reshape(B, pn, pn, z))
            fh_i, nxt_i = self.quant.next_ar_input(vq_params["quantize"], si, fh_i,
                                                   h_i.reshape(B, pn, pn, z))
            if si != SN - 1:
                nl = pns[si + 1] ** 2
                parts = [self.model._word_embed(params, nxt_c.reshape(B, nl, z)),
                         self.model._word_embed(params, nxt_i.reshape(B, nl, z))]
                if cfg.separator:
                    sp1, sp2 = self.model._separators(params, si, self.mask_first, B)
                    parts = [parts[0], sp1, parts[1], sp2]
                lo, hi = cfg.begin_ends[si + 1]
                nm = torch.cat(parts, dim=1) + self.model._lvl_pos(params)[:, lo:hi]
                if cfg.type_pos:
                    nm = nm + self.model._type_pos(params, self.mask_first)[:, lo:hi]
                next_map = nm.repeat(2, 1, 1)
        return next_map, cache_k, cache_v, fh_c, fh_i

    @torch.no_grad()
    def __call__(self, params, vq_params, labels, cond_type, generator: torch.Generator,
                 decode_img: bool = True):
        """labels, cond_type: (B,) class and cond-type ids. generator: a CPU
        torch.Generator, the source of every draw. Returns the (control,
        image) canvases (B, H, W, 3) in [0, 1], or their f_hats with
        decode_img=False."""
        pns = self.model.cfg.patch_nums
        B = labels.shape[0]
        z = self.vqvae.cfg.z_channels
        with span("prologue"):
            cond, next_map = self._prologue(params, labels.to(self.device),
                                            cond_type.to(self.device))
            cache_k, cache_v = self._init_caches(2 * B, params)
            fh_c = torch.zeros(B, pns[-1], pns[-1], z, device=self.device)
            fh_i = torch.zeros(B, pns[-1], pns[-1], z, device=self.device)
        for si in range(len(pns)):
            with span(f"scale/{si}"):
                next_map, cache_k, cache_v, fh_c, fh_i = self._step(
                    si, params, vq_params, cond, next_map, cache_k, cache_v, fh_c, fh_i,
                    generator)
        if not self.mask_first:  # the first stream was the image: swap back
            fh_c, fh_i = fh_i, fh_c
        if not decode_img:
            return fh_c, fh_i
        both = self._decode(vq_params, torch.cat([fh_c, fh_i], dim=0))
        return both[:B], both[B:]


@dataclasses.dataclass
class StepwiseCondSampler(_SamplerBase):
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
    more_smooth: bool = False
    decode: str = "both"    # "both", or only the generated "image"/"control"
    cache_mode: str = "stacked"
    kv_window: Optional[int] = None
    inplace_decode: bool = False
    kv_fused: bool = False
    device: DeviceLike = None
    compute_dtype: torch.dtype = torch.bfloat16
    sampler: str = "auto"

    def __post_init__(self):
        if (self.repeat_num not in (3, 4) or self.force not in ("control", "image")
                or self.decode not in ("both", "image", "control")):
            raise ValueError(f"unsupported repeat_num={self.repeat_num}, "
                             f"force={self.force!r} or decode={self.decode!r}")
        if self.model.cfg.separator or self.model.cfg.type_pos:
            raise ValueError("conditional sampling does not take separator/type_pos models "
                             "(nor does the reference's conditional sampler)")
        self._setup()

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
        R = self.repeat_num
        B = next_map.shape[0] // R
        z = self.vqvae.cfg.z_channels

        x, cache_k, cache_v = self._blocks(params, si, next_map, cond, cache_k, cache_v)
        t1, t2, t3 = (c * si / (SN - 1) for c in self.cfg_scales)
        # multi-scale CFG combined before the head matmul (weights sum to 1)
        w = ((1.0 + t1, t2 - t1, t3 - t2, -t3) if R == 4
             else (1.0 + t1, t2 - t1, -t2))
        combined = self._head(params, x, cond, w)
        l = pn * pn
        # draw [forced group's free half | uncond group's both halves]
        if self.force == "control":
            sample_in = torch.cat([combined[:, l:], combined], dim=1)
        else:
            sample_in = torch.cat([combined[:, :l], combined], dim=1)
        out = self._draw(sample_in, generator)
        a_sampled, b_ids = out[:, :l], out[:, l:]
        with span("canvas"):
            if self.force == "control":
                ids_a = torch.cat([forced, a_sampled], dim=1)
            else:
                ids_a = torch.cat([a_sampled, forced], dim=1)
            ids = torch.cat([ids_a, b_ids], dim=0)                    # (2B, 2l)
            if self.more_smooth:  # gumbel soft embeddings of both groups' streams
                factor, tau = smooth_temperature(si, SN)
                soft = gumbel_softmax(combined.repeat(2, 1, 1) * factor, tau,
                                      generator=generator)
                h_all = soft @ vq_params["quantize"]["embedding"].float()
                h_c, h_i = h_all[:, :l], h_all[:, l:]
            else:
                h_c = self.quant.embed(vq_params["quantize"], ids[:, :l])
                h_i = self.quant.embed(vq_params["quantize"], ids[:, l:])
            fh_c, nxt_c = self.quant.next_ar_input(vq_params["quantize"], si, fh_c,
                                                   h_c.reshape(2 * B, pn, pn, z))
            fh_i, nxt_i = self.quant.next_ar_input(vq_params["quantize"], si, fh_i,
                                                   h_i.reshape(2 * B, pn, pn, z))
            if si != SN - 1:
                nl = pns[si + 1] ** 2
                nm_c = self.model._word_embed(params, nxt_c.reshape(2 * B, nl, z))
                nm_i = self.model._word_embed(params, nxt_i.reshape(2 * B, nl, z))
                nm = torch.cat([nm_c, nm_i], dim=1)
                lo, hi = cfg.begin_ends[si + 1]
                nm = nm + self.model._lvl_pos(params)[:, lo:hi]
                next_map = torch.cat([nm[:B].repeat(R - 1, 1, 1), nm[B:]], dim=0)
        return next_map, cache_k, cache_v, fh_c, fh_i

    def _epilogue(self, vq_params, fh_c, fh_i):
        B = fh_c.shape[0] // 2
        if self.decode == "image":
            return fh_c[:B], self._decode(vq_params, fh_i[:B])
        if self.decode == "control":
            return self._decode(vq_params, fh_c[:B]), fh_i[:B]
        both = self._decode(vq_params, torch.cat([fh_c[:B], fh_i[:B]], dim=0))
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
        with span("prologue"):
            labels = labels.to(self.device)
            cond_type = cond_type.to(self.device)
            cond, next_map = self._prologue(params, labels, cond_type)
            cache_k, cache_v = self._init_caches(self.repeat_num * B, params)
            fh_c = torch.zeros(2 * B, pns[-1], pns[-1], z, device=self.device)
            fh_i = torch.zeros(2 * B, pns[-1], pns[-1], z, device=self.device)
        for si in range(cfg.num_scales):
            with span(f"scale/{si}"):
                next_map, cache_k, cache_v, fh_c, fh_i = self._step_fn(
                    si, params, vq_params, cond, next_map, cache_k, cache_v,
                    fh_c, fh_i, generator, forced_ids[si].to(self.device))
        if not decode_img:
            return fh_c[:B], fh_i[:B]
        return self._epilogue(vq_params, fh_c, fh_i)


@dataclasses.dataclass
class StepwiseVARSampler(_SamplerBase):
    """Plain-VAR class-conditional CFG generation: two CFG branches [cond |
    uncond] over B rows each, one token stream, one canvas (the JAX
    package's `StepwiseVARSampler`, with `more_smooth` from its
    `VARModel.sample_cfg`)."""

    model: object  # VARModel
    vqvae: VQVAE
    cfg_scale: float = 1.5
    top_k: int = 900
    top_p: float = 0.96
    more_smooth: bool = False
    cache_mode: str = "stacked"
    kv_window: Optional[int] = None
    inplace_decode: bool = False
    kv_fused: bool = False
    device: DeviceLike = None
    compute_dtype: torch.dtype = torch.bfloat16
    sampler: str = "auto"

    def __post_init__(self):
        self._full_mask = None  # plain VAR has no indep masking
        self._setup_caches()

    def _step(self, si, params, vq_params, cond, next_map, cache_k, cache_v, f_hat,
              generator):
        cfg = self.model.cfg
        pns, SN = cfg.patch_nums, cfg.num_scales
        pn = pns[si]
        B = next_map.shape[0] // 2
        z = self.vqvae.cfg.z_channels
        x, cache_k, cache_v = self._blocks(params, si, next_map, cond, cache_k, cache_v)
        t = self.cfg_scale * si / (SN - 1)
        with span("head"):
            logits = tfm.head_logits_cfg(params, x, cond, cfg, (1.0 + t, -t))
        ids = self._draw(logits, generator)
        with span("canvas"):
            if self.more_smooth:  # gumbel soft embeddings
                factor, tau = smooth_temperature(si, SN)
                soft = gumbel_softmax(logits * factor, tau, generator=generator)
                h = soft @ vq_params["quantize"]["embedding"].float()
            else:
                h = self.quant.embed(vq_params["quantize"], ids)
            f_hat, nxt = self.quant.next_ar_input(vq_params["quantize"], si, f_hat,
                                                  h.reshape(B, pn, pn, z))
            if si != SN - 1:
                lo, hi = cfg.begin_ends[si + 1]
                nm = self.model._word_embed(params, nxt.reshape(B, hi - lo, z))
                next_map = (nm + self.model._lvl_pos(params)[:, lo:hi]).repeat(2, 1, 1)
        return next_map, cache_k, cache_v, f_hat

    @torch.no_grad()
    def __call__(self, params, vq_params, labels, generator: torch.Generator,
                 decode_img: bool = True):
        """labels: (B,) class ids. generator: a CPU torch.Generator, the
        source of every draw. Returns the images (B, H, W, 3) in [0, 1], or
        the final f_hat with decode_img=False."""
        cfg = self.model.cfg
        pns = cfg.patch_nums
        B = labels.shape[0]
        with span("prologue"):
            labels = labels.to(self.device)
            null = torch.full_like(labels, cfg.num_classes)
            cond = params["class_emb"][torch.cat([labels, null])]
            next_map = (cond[:, None, :] + params["pos_start"]
                        + self.model._lvl_pos(params)[:, : cfg.first_l])
            cache_k, cache_v = self._init_caches(2 * B, params)
            f_hat = torch.zeros(B, pns[-1], pns[-1], self.vqvae.cfg.z_channels,
                                device=self.device)
        for si in range(len(pns)):
            with span(f"scale/{si}"):
                next_map, cache_k, cache_v, f_hat = self._step(
                    si, params, vq_params, cond, next_map, cache_k, cache_v, f_hat,
                    generator)
        return self._decode(vq_params, f_hat) if decode_img else f_hat
