"""ControlVAR: joint control+image next-scale AR transformer (parameters and
embedding helpers; the conditional sampler is eval/stepwise.py).

Every scale holds an interleaved pair (control_k, image_k); the first scale
is the pair (cond-type embedding, class embedding).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from controlvar_tpu_torch.config import ControlVARConfig
from controlvar_tpu_torch.device import (DeviceLike, generator_for,
                                        resolve_device, tree_to)
from controlvar_tpu_torch.models import transformer as tfm
from controlvar_tpu_torch.models.masks import level_index_1L

Params = Dict


class ControlVARModel:
    """Model entry point. Runs on `cuda` unless device="cpu" is passed."""

    def __init__(self, cfg: ControlVARConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        lvl = level_index_1L(cfg.patch_nums, cfg.mask_factor, cfg.separator)
        # the (L,) scale index of every token, copied to the device once
        self._level_index = torch.from_numpy(lvl).long().to(self.device)

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
