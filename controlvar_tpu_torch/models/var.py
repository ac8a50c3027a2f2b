"""VAR: the class-conditional next-scale autoregressive transformer.

Port of `controlvar_tpu/models/var.py`: parameters, the embedding helpers,
the teacher-forced training forward and class-conditional CFG sampling.
Sampling runs `eval/stepwise.py:StepwiseVARSampler`: in eager PyTorch the
JAX package's one-jit `sample_cfg` and its stepwise sampler are the same
loop.

Params: word_embed{kernel, bias}, class_emb (K+1, C), pos_start, pos_1LC,
lvl_embed (S, C), blocks{... stacked ...}, head_nm, head; with shared_aln
also shared_ada_lin{kernel (C, 6C), bias (6C,)}.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from controlvar_tpu_torch.config import VARConfig
from controlvar_tpu_torch.device import DeviceLike, generator_for, resolve_device, tree_to
from controlvar_tpu_torch.models import transformer as tfm
from controlvar_tpu_torch.models.masks import block_causal_mask, level_index_1L
from controlvar_tpu_torch.ops.attention import tile_flags

Params = Dict


class VARModel:
    """Model entry point. Runs on `cuda` unless device="cpu" is passed.
    mesh: the process layout; a model axis above 1 raises
    NotImplementedError (no JAX entry point runs plain VAR on a mesh)."""

    def __init__(self, cfg: VARConfig, device: DeviceLike = None, mesh=None):
        if mesh is not None and mesh.model > 1:
            raise NotImplementedError(f"a model axis of {mesh.model}: VARModel and VARTrainStep "
                                      "run on one device or data parallel (no JAX entry "
                                      "point runs plain VAR on a mesh)")
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        # the (L,) scale index of every token, copied to the device once
        self._level_index = torch.from_numpy(level_index_1L(cfg.patch_nums)).long().to(
            self.device)
        # the (L, L) block-causal training mask, copied to the device once,
        # and the flags of its 64 x 64 tiles that the attention kernels read
        self._attn_mask = torch.tensor(block_causal_mask(cfg.patch_nums), device=self.device)
        self._tile_flags = tile_flags(self._attn_mask)

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
        p.update(tfm.init_head_params(g, cfg, cfg.vocab_size))
        if cfg.shared_aln:
            p["shared_ada_lin"] = {"kernel": tfm._trunc_normal(g, (C, 6 * C), 0.02),
                                   "bias": torch.zeros(6 * C)}
        return tree_to(p, self.device)

    def _lvl_pos(self, params: Params) -> torch.Tensor:
        """(1, L, C) level embedding + absolute position of every token."""
        lvl = self._level_index.to(params["lvl_embed"].device)
        return params["lvl_embed"][lvl][None] + params["pos_1LC"]

    def _word_embed(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ params["word_embed"]["kernel"] + params["word_embed"]["bias"]

    def _drop_class(self, labels: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """Classifier-free-guidance training drop: each class id becomes the
        unconditional id num_classes with probability cond_drop_rate."""
        u = torch.rand(labels.shape[0], generator=generator).to(labels.device)
        return torch.where(u < self.cfg.cond_drop_rate, self.cfg.num_classes, labels)

    def forward_train(self, params: Params, labels: torch.Tensor, x_tf: torch.Tensor,
                      generator: Optional[torch.Generator] = None, train: bool = True,
                      compute_dtype=torch.bfloat16, remat: str = "full",
                      use_flash: bool = True) -> torch.Tensor:
        """Teacher-forced logits (B, L, V) fp32 (reference: var.py:209-253).

        labels (B,) class ids; x_tf (B, L - first_l, Cvae) teacher-forcing
        features. With train and a generator, each class is dropped to the
        unconditional id with probability cond_drop_rate and drop path is
        drawn from the same generator; with train, every layer is recomputed
        in the backward under the remat policy (`transformer.blocks_forward`).
        The residual stream runs in compute_dtype: bf16 on the GPU, where
        attention goes through K3/K4 under the block-causal mask;
        use_flash=False takes the plain einsum attention
        (`ops.attention.mha_xla`) instead, on any device.
        """
        cfg = self.cfg
        if train and generator is not None:
            labels = self._drop_class(labels, generator)
        cond = params["class_emb"][labels]
        sos = cond[:, None, :] + params["pos_start"]
        x = torch.cat([sos, self._word_embed(params, x_tf)], dim=1)
        x = x + self._lvl_pos(params)
        x = tfm.blocks_forward(params["blocks"], x.to(compute_dtype), cond, cfg,
                               self._attn_mask.to(x.device),
                               flags=self._tile_flags.to(x.device), train=train,
                               generator=generator, remat=remat,
                               shared_lin=params.get("shared_ada_lin"), use_flash=use_flash)
        return tfm.head_logits(params, x, cond, cfg)

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
