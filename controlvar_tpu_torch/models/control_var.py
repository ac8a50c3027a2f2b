"""ControlVAR: joint control+image next-scale AR transformer (parameters,
embedding helpers, the teacher-forced training forward, joint sampling in
the `replace` and `separate_decoding` modes, and the model-level
teacher-forced conditional sampler `sample_cond_cfg`; the step-wise
conditional and interleaved joint samplers are eval/stepwise.py).

Every scale holds an interleaved pair (control_k, image_k); the first scale
is the pair (cond-type embedding, class embedding). A `replace` model
(mask_factor 1) holds one pn^2 segment a scale. The options: `separator`
follows every segment after scale 0 with a learned separator embedding
(whose target is its mapping index + vocab_size), `type_pos` adds a learned
control/image type embedding to every token, `shared_aln` makes the AdaLN
modulations from one model-level linear, and `bidirectional` trains both
stream orders (`mask_first`).

With a mesh whose model axis is above 1 (`parallel/mesh.py`), the model is
tensor parallel: its params are this rank's shard
(`parallel/tensor.py:shard_params` of `init_params`), the blocks and the
head run Megatron's layout (`models/transformer.py`), and every draw is
model rank 0's, broadcast over the model group. Every option runs tensor
parallel: the separator's `special_embed`, type_pos's `type_embed` and
shared_aln's `shared_ada_lin` and `ada_gss` stay whole on every rank (the
shared modulation is made before any collective), the separator's V + 18
head columns are cut where the model axis divides them and whole
elsewhere, and a bidirectional model takes the stream order its caller
gives every rank. Separate decoding, which no JAX entry point runs on a
mesh, raises NotImplementedError there.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from controlvar_tpu_torch.config import COND_UNCOND_ID, ControlVARConfig
from controlvar_tpu_torch.device import (DeviceLike, generator_for,
                                        resolve_device, tree_to)
from controlvar_tpu_torch.models import transformer as tfm
from controlvar_tpu_torch.models.masks import (attn_mask_for_config, level_index_1L,
                                              type_index_1L)
from controlvar_tpu_torch.ops.attention import tile_flags
from controlvar_tpu_torch.ops.resize import resize_area
from controlvar_tpu_torch.ops.sampling import (gumbel_softmax, sample_top_k_top_p,
                                               smooth_temperature)
from controlvar_tpu_torch.parallel.mesh import tp_of
from controlvar_tpu_torch.parallel.tensor import broadcast_from_model_root
from controlvar_tpu_torch.utils.tracker import span

Params = Dict


def separator_mapping(mask_first: bool) -> List[int]:
    """The special_embed row of each separator slot, in sequence order: the
    identity when mask_first, each (control, image) pair swapped otherwise."""
    if mask_first:
        return list(range(18))
    return [i + 1 if i % 2 == 0 else i - 1 for i in range(18)]


def tp_draw(ids: torch.Tensor, tp) -> torch.Tensor:
    """A draw made on every rank of a tensor-parallel model group, as its
    model rank 0 made it (in place; ids itself without tp): the ranks cannot
    diverge, whatever their own draws gave."""
    return ids if tp is None else broadcast_from_model_root(ids, tp)


class ControlVARModel:
    """Model entry point. Runs on `cuda` unless device="cpu" is passed.
    mesh: the process layout (`parallel.mesh.make_mesh`); a model axis above
    1 makes the model tensor parallel (module docstring)."""

    def __init__(self, cfg: ControlVARConfig, device: DeviceLike = None, mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.tp = tp_of(mesh)
        lvl = level_index_1L(cfg.patch_nums, cfg.mask_factor, cfg.separator)
        # the (L,) scale index of every token, copied to the device once
        self._level_index = torch.from_numpy(lvl).long().to(self.device)
        # the (L, L) training attention mask, copied to the device once, and
        # the flags of its 64 x 64 tiles that the attention kernels read
        self._attn_mask = torch.tensor(attn_mask_for_config(cfg), device=self.device)
        self._tile_flags = tile_flags(self._attn_mask)
        # type_pos: the (L,) type index of every token in each stream order
        self._type_index = None
        if cfg.type_pos:
            self._type_index = {
                mf: torch.from_numpy(type_index_1L(cfg.patch_nums, cfg.separator, mf)).long()
                .to(self.device) for mf in (True, False)}

    def init_params(self, seed: int) -> Params:
        """Reference-default initialized fp32 params from a seed, on self.device."""
        cfg = self.cfg
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
        if cfg.type_pos:
            p["type_embed"] = tfm._trunc_normal(g, (cfg.mask_factor, C), init_std)
        if cfg.separator:
            p["special_embed"] = tfm._trunc_normal(
                g, ((cfg.num_scales - 1) * cfg.mask_factor, C), init_std)
        if cfg.shared_aln:
            p["shared_ada_lin"] = {"kernel": tfm._trunc_normal(g, (C, 6 * C), 0.02),
                                   "bias": torch.zeros(6 * C)}
        return tree_to(p, self.device)

    def _lvl_pos(self, params: Params) -> torch.Tensor:
        """(1, L, C) level embedding + absolute position of every token."""
        lvl = self._level_index.to(params["lvl_embed"].device)
        return params["lvl_embed"][lvl][None] + params["pos_1LC"]

    def _type_pos(self, params: Params, mask_first: bool) -> torch.Tensor:
        """(1, L, C) type embedding of every token in the stream order."""
        idx = self._type_index[mask_first].to(params["type_embed"].device)
        return params["type_embed"][idx][None]

    def _word_embed(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ params["word_embed"]["kernel"] + params["word_embed"]["bias"]

    def _separators(self, params: Params, si: int, mask_first: bool, B: int):
        """The two (B, 1, C) separator embeddings that follow the control and
        the image segment of scale si + 1, in the stream order."""
        mapping = separator_mapping(mask_first)
        sp = params["special_embed"]
        return tuple(sp[mapping[2 * si + j]].expand(B, 1, -1) for j in (0, 1))

    def _sos(self, params: Params, labels: torch.Tensor,
             cond_type: Optional[torch.Tensor], mask_first: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cond (N, C), sos (N, first_l, C)) with pos_start added: the pair
        [cond-type embedding, class embedding] for multi_cond (swapped when
        not mask_first), else the class embedding repeated; a bidirectional
        model without multi_cond multiplies its two halves by (-1, +1) when
        mask_first, (+1, -1) otherwise, after pos_start is added."""
        cfg = self.cfg
        cond = params["class_emb"][labels]
        if cfg.multi_cond and cfg.mask_factor == 2:
            ct = params["cond_embed"][cond_type]
            pair = [ct, cond] if mask_first else [cond, ct]
            return cond, torch.stack(pair, dim=1) + params["pos_start"]
        sos = cond[:, None, :] + params["pos_start"]
        if cfg.bidirectional and cfg.mask_factor == 2:
            sign, half = (-1.0 if mask_first else 1.0), cfg.first_l // 2
            return cond, torch.cat([sos[:, :half] * sign, sos[:, half:] * -sign], dim=1)
        return cond, sos

    def _splice_separators(self, params: Params, sos: torch.Tensor, x_embed: torch.Tensor,
                           mask_first: bool) -> torch.Tensor:
        """[sos | ctrl_1, sep, img_1, sep | ...]: the learned separator after
        every segment of the scales after the first."""
        B = x_embed.shape[0]
        parts, cur = [sos], 0
        for si, pn in enumerate(self.cfg.patch_nums[1:]):
            l = pn * pn
            sp1, sp2 = self._separators(params, si, mask_first, B)
            parts += [x_embed[:, cur: cur + l], sp1, x_embed[:, cur + l: cur + 2 * l], sp2]
            cur += 2 * l
        return torch.cat(parts, dim=1)

    def _drop_cond(self, labels: torch.Tensor, cond_type: Optional[torch.Tensor],
                   generator: torch.Generator):
        """Classifier-free-guidance training drop: each class id becomes the
        unconditional id num_classes, and each cond type COND_UNCOND_ID,
        independently with probability cond_drop_rate."""
        cfg = self.cfg
        with span("wait"):  # a blocking copy of the host's draw to the card
            u = torch.rand(2, labels.shape[0], generator=generator).to(labels.device)
        labels = torch.where(u[0] < cfg.cond_drop_rate, cfg.num_classes, labels)
        if cfg.multi_cond and cond_type is not None:
            cond_type = torch.where(u[1] < cfg.cond_drop_rate, COND_UNCOND_ID, cond_type)
        return labels, cond_type

    def forward_train(self, params: Params, labels: torch.Tensor, x_tf: torch.Tensor,
                      cond_type: Optional[torch.Tensor] = None, mask_first: bool = True,
                      generator: Optional[torch.Generator] = None, train: bool = True,
                      compute_dtype=torch.bfloat16, remat: str = "full",
                      use_flash: bool = True) -> torch.Tensor:
        """Teacher-forced logits (B, L, head_vocab) fp32.

        labels (B,) class ids; x_tf (B, L_words - first_l, Cvae) interleaved
        teacher-forcing features, without separator slots (the learned
        separators are spliced in here); cond_type (B,) for multi_cond;
        mask_first: the stream order (control first when True). With train
        and a generator, the class (and cond type) is dropped to the
        unconditional id with probability cond_drop_rate, and drop path is
        drawn from the same generator; with train, every layer is recomputed
        in the backward under the remat policy (`transformer.blocks_forward`).
        The residual stream runs in compute_dtype: bf16 on the GPU, where
        attention goes through K3/K4; use_flash=False takes the plain
        einsum attention instead (`ops.attention.mha_xla`, the parity
        check's path), on any device.
        """
        cfg = self.cfg
        if train and generator is not None:
            labels, cond_type = self._drop_cond(labels, cond_type, generator)
        cond, sos = self._sos(params, labels, cond_type, mask_first)
        x_embed = self._word_embed(params, x_tf)
        if cfg.separator:
            x = self._splice_separators(params, sos, x_embed, mask_first)
        else:
            x = torch.cat([sos, x_embed], dim=1)
        x = x + self._lvl_pos(params)
        if cfg.type_pos:
            x = x + self._type_pos(params, mask_first)
        x = tfm.blocks_forward(params["blocks"], x.to(compute_dtype), cond, cfg,
                               self._attn_mask.to(x.device),
                               flags=self._tile_flags.to(x.device), train=train,
                               generator=generator, remat=remat,
                               shared_lin=params.get("shared_ada_lin"), tp=self.tp,
                               use_flash=use_flash)
        return tfm.head_logits(params, x, cond, cfg, self.tp)

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
        logits = tfm.head_logits_cfg(params, x, cond, self.cfg, (1.0 + t, -t), self.tp)
        logits = logits[:, :, : self.cfg.vocab_size]
        ids = tp_draw(sample_top_k_top_p(logits, top_k, top_p, generator), self.tp)
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
                                             self.device,
                                             heads=tfm.local_heads(params["blocks"], cfg))
        fh = torch.zeros(B, pns[-1], pns[-1], z, device=self.device)
        for si, pn in enumerate(pns):
            lo, hi = cfg.begin_ends[si]
            mask_slice = self._attn_mask[lo:hi, :hi] if cfg.indep else None
            x, cache_k, cache_v = tfm.blocks_decode(params["blocks"], next_map.to(compute_dtype),
                                                    cond, cfg, cache_k, cache_v, lo,
                                                    mask_slice=mask_slice,
                                                    shared_lin=params.get("shared_ada_lin"),
                                                    tp=self.tp)
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
        input feeds scale k+1's control segment. With a separator, every
        segment after scale 0 ends with its separator embedding, whose drawn
        id is dropped. Returns the (control, image) canvases as
        `sample_joint_cfg` does."""
        cfg = self.cfg
        if self.tp is not None:
            raise NotImplementedError("separate decoding runs on one device (no JAX entry "
                                      "point runs it on a mesh)")
        if not cfg.separate_decoding or cfg.indep:
            raise ValueError("sample_joint_separate needs separate_decoding without indep")
        if cfg.mask_factor != 2 or not cfg.multi_cond:
            raise ValueError("sample_joint_separate needs mask_factor=2 and multi_cond")
        if cfg.type_pos:
            raise ValueError("type_pos separate decoding is broken in the reference")
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
        mapping = separator_mapping(mask_first)
        cache_k, cache_v = tfm.init_kv_cache(cfg, 2 * B, cfg.seq_len, compute_dtype,
                                             self.device)
        fh_1 = torch.zeros(B, pns[-1], pns[-1], z, device=self.device)
        fh_2 = torch.zeros_like(fh_1)
        cur = 0
        for si in range(2 * SN):
            sc = si // 2
            pn = pns[sc]
            x, cache_k, cache_v = tfm.blocks_decode(params["blocks"], x_next.to(compute_dtype),
                                                    cond, cfg, cache_k, cache_v, cur,
                                                    shared_lin=params.get("shared_ada_lin"))
            h = self._draw(params, vq_params, vqvae, x, cond, sc, cfg_scale, top_k,
                           top_p, more_smooth, generator, pn * pn).reshape(B, pn, pn, z)
            cur += x.shape[1]
            if si % 2 == 0:  # control segment: the image input at the same scale
                fh_1, _ = vqvae.quantizer.next_ar_input(vq_params["quantize"], sc, fh_1, h)
                nxt = resize_area(fh_1, pn, pn)
            else:            # image segment: the next scale's control input
                fh_2, nxt = vqvae.quantizer.next_ar_input(vq_params["quantize"], sc, fh_2, h)
            if si == 0:
                x_next = first[:, pns[0] ** 2:]
            elif si != 2 * SN - 1:
                nl = pns[(si + 1) // 2] ** 2
                nm = self._word_embed(params, nxt.reshape(B, nl, z))
                if cfg.separator:
                    nm = torch.cat([nm, params["special_embed"][mapping[si - 1]].expand(B, 1, -1)],
                                   dim=1)
                nm = nm + lvl_pos[:, cur: cur + nm.shape[1]]
                x_next = nm.repeat(2, 1, 1)
        if not mask_first:
            fh_1, fh_2 = fh_2, fh_1
        if not decode_img:
            return fh_1, fh_2
        both = (vqvae.fhat_to_img(vq_params, torch.cat([fh_1, fh_2]), compute_dtype) + 1.0) * 0.5
        return both[:B], both[B:]

    # ---- teacher-forced conditional sampling --------------------------------

    @torch.no_grad()
    def sample_cond_cfg(self, params: Params, vqvae, vq_params: Params, labels: torch.Tensor,
                        cond_type: torch.Tensor, generator: torch.Generator,
                        cfg_scales: Tuple[float, float, float] = (4.0, 4.0, 4.0),
                        c_mask: Optional[Sequence[torch.Tensor]] = None,
                        c_img: Optional[Sequence[torch.Tensor]] = None,
                        top_k: int = 900, top_p: float = 0.96,
                        compute_dtype: torch.dtype = torch.bfloat16, decode_img: bool = True,
                        repeat_num: int = 4, more_smooth: bool = False):
        """Control- (or image-) conditional generation with multi-scale CFG
        and per-scale teacher forcing (the JAX package's `sample_cond_cfg`).

        c_mask / c_img: optional per-scale (B, pn^2) ids that replace the
        drawn control / image ids. repeat_num 4 runs the CFG branches [full |
        class dropped | class and type dropped | uncond] with cond types [c,
        c, uncond, uncond] and combines their logits as (1 + t1) a + (t2 -
        t1) b + (t3 - t2) c - t3 d, each t ramped over the scales; repeat_num
        3 drops the third branch: (1 + t1) a + (t2 - t1) b - t2 c. Two
        token-stream groups, [forced (B) | uncond (B)], share the draws: the
        forced group's next-scale input goes to the R - 1 conditioned
        branches. Each scale draws, in one call of K2 on the card, the forced
        group's free columns then both halves of the uncond group. With
        more_smooth the canvases take gumbel-softmax embeddings of the
        combined logits (the teacher forcing then moves only the ids).
        generator: a CPU torch.Generator, the source of every draw. Returns
        the forced group's (control, image) canvases (B, H, W, 3) in [0, 1],
        or their f_hats with decode_img=False."""
        cfg = self.cfg
        if cfg.mask_factor != 2:
            raise ValueError("sample_cond_cfg needs mask_factor=2")
        if cfg.separator or cfg.type_pos:
            raise ValueError("sample_cond_cfg does not take separator/type_pos models (the "
                             "reference's conditional sampler never splices separators nor "
                             "adds type positions)")
        if repeat_num not in (3, 4):
            raise ValueError(f"repeat_num={repeat_num}: want 3 or 4")
        R, pns, SN, z = repeat_num, cfg.patch_nums, cfg.num_scales, vqvae.cfg.z_channels
        quant, q_params = vqvae.quantizer, vq_params["quantize"]
        B = labels.shape[0]
        labels, cond_type = labels.to(self.device), cond_type.to(self.device)
        null = torch.full_like(labels, cfg.num_classes)
        unc = torch.full_like(cond_type, COND_UNCOND_ID)
        cond = params["class_emb"][torch.cat([labels] + [null] * (R - 1))]
        ct_tok = params["cond_embed"][torch.cat([cond_type, cond_type] + [unc] * (R - 2))]
        lvl_pos = self._lvl_pos(params)
        next_map = (torch.stack([ct_tok, cond], dim=1) + params["pos_start"]
                    + lvl_pos[:, : cfg.first_l])
        cache_k, cache_v = tfm.init_kv_cache(cfg, R * B, cfg.seq_len, compute_dtype,
                                             self.device,
                                             heads=tfm.local_heads(params["blocks"], cfg))
        fh_c = torch.zeros(2 * B, pns[-1], pns[-1], z, device=self.device)
        fh_i = torch.zeros_like(fh_c)
        for si, pn in enumerate(pns):
            lo, hi = cfg.begin_ends[si]
            l = pn * pn
            mask_slice = self._attn_mask[lo:hi, :hi] if cfg.indep else None
            x, cache_k, cache_v = tfm.blocks_decode(params["blocks"], next_map.to(compute_dtype),
                                                    cond, cfg, cache_k, cache_v, lo,
                                                    mask_slice=mask_slice,
                                                    shared_lin=params.get("shared_ada_lin"),
                                                    tp=self.tp)
            t1, t2, t3 = (c * si / (SN - 1) for c in cfg_scales)
            w = ((1.0 + t1, t2 - t1, t3 - t2, -t3) if R == 4 else (1.0 + t1, t2 - t1, -t2))
            combined = tfm.head_logits_cfg(params, x, cond, cfg, w,
                                           self.tp)[:, :, : cfg.vocab_size]
            # draw only the columns that are used: the forced group's free
            # half (or both halves) and the uncond group's both halves
            parts = ([] if c_mask is not None else [combined[:, :l]]) + (
                [] if c_img is not None else [combined[:, l:]])
            na = sum(p.shape[1] for p in parts)
            out = tp_draw(sample_top_k_top_p(torch.cat(parts + [combined], dim=1), top_k,
                                             top_p, generator), self.tp)
            a_sampled, b_ids = out[:, :na], out[:, na:]
            a_ctrl = c_mask[si].to(out) if c_mask is not None else a_sampled[:, :l]
            a_img = c_img[si].to(out) if c_img is not None else a_sampled[:, na - l:]
            ids = torch.cat([torch.cat([a_ctrl, a_img], dim=1), b_ids], dim=0)   # (2B, 2l)
            if more_smooth:
                factor, tau = smooth_temperature(si, SN)
                soft = gumbel_softmax(combined.repeat(2, 1, 1) * factor, tau, generator=generator)
                h_all = soft @ q_params["embedding"].float()
                h_c, h_i = h_all[:, :l], h_all[:, l:]
            else:
                h_c, h_i = quant.embed(q_params, ids[:, :l]), quant.embed(q_params, ids[:, l:])
            fh_c, nxt_c = quant.next_ar_input(q_params, si, fh_c, h_c.reshape(2 * B, pn, pn, z))
            fh_i, nxt_i = quant.next_ar_input(q_params, si, fh_i, h_i.reshape(2 * B, pn, pn, z))
            if si != SN - 1:
                nl = pns[si + 1] ** 2
                lo, hi = cfg.begin_ends[si + 1]
                nm = torch.cat([self._word_embed(params, nxt_c.reshape(2 * B, nl, z)),
                                self._word_embed(params, nxt_i.reshape(2 * B, nl, z))], dim=1)
                nm = nm + lvl_pos[:, lo:hi]
                next_map = torch.cat([nm[:B].repeat(R - 1, 1, 1), nm[B:]], dim=0)
        fh_c, fh_i = fh_c[:B], fh_i[:B]
        if not decode_img:
            return fh_c, fh_i
        both = (vqvae.fhat_to_img(vq_params, torch.cat([fh_c, fh_i]), compute_dtype) + 1.0) * 0.5
        return both[:B], both[B:]
