"""ControlVAR: joint control+image next-scale AR transformer (parameters,
embedding helpers and the teacher-forced training forward; the conditional
sampler is eval/stepwise.py).

Every scale holds an interleaved pair (control_k, image_k); the first scale
is the pair (cond-type embedding, class embedding).
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
