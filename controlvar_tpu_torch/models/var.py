"""VAR: the class-conditional next-scale autoregressive transformer.

Port of `controlvar_tpu/models/var.py` for generation: parameters, the
embedding helpers and class-conditional CFG sampling. Sampling runs
`eval/stepwise.py:StepwiseVARSampler`: in eager PyTorch the JAX package's
one-jit `sample_cfg` and its stepwise sampler are the same loop. The
teacher-forced `forward_train` is not ported yet.

Params: word_embed{kernel, bias}, class_emb (K+1, C), pos_start, pos_1LC,
lvl_embed (S, C), blocks{... stacked ...}, head_nm, head.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from controlvar_tpu_torch.config import VARConfig
from controlvar_tpu_torch.device import DeviceLike, generator_for, resolve_device, tree_to
from controlvar_tpu_torch.models import transformer as tfm
from controlvar_tpu_torch.models.masks import level_index_1L

Params = Dict


class VARModel:
    """Model entry point. Runs on `cuda` unless device="cpu" is passed."""

    def __init__(self, cfg: VARConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # the (L,) scale index of every token, copied to the device once
        self._level_index = torch.from_numpy(level_index_1L(cfg.patch_nums)).long().to(
            self.device)

    def init_params(self, seed: int) -> Params:
        """Reference-default initialized fp32 params from a seed, on self.device."""
        cfg = self.cfg
        if cfg.shared_aln:
            raise NotImplementedError("shared_aln is not ported yet")
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
        p.update(tfm.init_head_params(g, cfg, cfg.vocab_size))
        return tree_to(p, self.device)

    def _lvl_pos(self, params: Params) -> torch.Tensor:
        """(1, L, C) level embedding + absolute position of every token."""
        lvl = self._level_index.to(params["lvl_embed"].device)
        return params["lvl_embed"][lvl][None] + params["pos_1LC"]

    def _word_embed(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ params["word_embed"]["kernel"] + params["word_embed"]["bias"]

    def sample_cfg(self, params: Params, vqvae, vq_params: Params, labels: torch.Tensor,
                   generator: torch.Generator, cfg_scale: float = 1.5, top_k: int = 0,
                   top_p: float = 0.0, decode_img: bool = True, more_smooth: bool = False,
                   compute_dtype: torch.dtype = torch.bfloat16):
        """Class-conditional CFG generation (the JAX package's `sample_cfg`):
        images (B, H, W, 3) in [0, 1], or the final f_hat (B, pn, pn, Cvae)
        with decode_img=False. more_smooth: gumbel-softmax token embeddings
        instead of hard lookups. generator: a CPU torch.Generator, the
        source of every draw."""
        from controlvar_tpu_torch.eval.stepwise import StepwiseVARSampler

        sampler = StepwiseVARSampler(self, vqvae, cfg_scale=cfg_scale, top_k=top_k, top_p=top_p,
                                     more_smooth=more_smooth, device=self.device,
                                     compute_dtype=compute_dtype)
        return sampler(params, vq_params, labels, generator, decode_img=decode_img)
