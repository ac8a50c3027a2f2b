"""VAR -> ControlVAR checkpoint surgery.

The port of `controlvar_tpu/ckpt/surgery.py`: initialize a ControlVAR from
a pretrained plain-VAR checkpoint (reference: train_control_var_hpu.py:
472-534). The L=680 position table is expanded to the interleaved
L=1360(+sep) layout, the head is padded for the separator vocab, the
leaves new to ControlVAR (pos_start, cond/type/special embeds) keep their
fresh init, and every other weight transfers unchanged. Fresh slots are
drawn from an explicit torch.Generator (the JAX package draws them from its
key, so those values differ between the two; every transferred slot is
equal).
"""
from __future__ import annotations

from typing import Dict, Literal, Optional

import numpy as np
import torch

from controlvar_tpu_torch.config import ControlVARConfig
from controlvar_tpu_torch.device import generator_for, tree_map

Params = Dict


def _trunc_normal_2sd(g: torch.Generator, shape, std: float) -> torch.Tensor:
    """std * a normal truncated at +-2 standard deviations, as
    `std * jax.random.truncated_normal(key, -2, 2, shape)`."""
    t = torch.empty(*shape)
    return std * torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)


def expand_pos_1LC(pos: torch.Tensor, cfg: ControlVARConfig,
                   mode: Literal["concat", "interpos"] = "concat", mpos: bool = False,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(1, 680, C) VAR positions -> (1, L, C) ControlVAR positions.

    mode='concat': whole-sequence duplication [pos; pos] (the reference's
    default path, train_control_var_hpu.py:524). mode='interpos': per-scale
    duplication [pos_k, pos_k] (reference :495-505). With cfg.separator the
    separator slots are drawn fresh from `generator` and, with mpos, the
    second copy is negated (reference :507-521)."""
    C = pos.shape[-1]
    init_std = float(np.sqrt(1.0 / C / 3.0))
    if not cfg.separator and mode == "concat":
        return torch.cat([pos, pos], dim=1)
    g = generator if generator is not None else generator_for(0)
    parts, L = [], 0
    for i, pn in enumerate(cfg.patch_nums):
        l = pn * pn
        num_sp = 1 if (i != 0 and cfg.separator) else 0
        seg = (l + num_sp) * cfg.mask_factor
        pe = _trunc_normal_2sd(g, (seg, C), init_std).to(device=pos.device, dtype=pos.dtype)
        src = pos[0, L: L + l]
        pe[:l] = src
        pe[l + num_sp: 2 * l + num_sp] = src * (-1.0 if (cfg.separator and mpos) else 1.0)
        parts.append(pe)
        L += l
    return torch.cat(parts, dim=0)[None]


def pad_head_for_separators(head: Params, cfg: ControlVARConfig,
                            generator: torch.Generator) -> Params:
    """Pad the vocab projection with columns for the 2*(S-1) separator
    classes (reference: train_control_var_hpu.py:526-534)."""
    if cfg.num_sep_tokens == 0:
        return head
    kernel, bias = head["kernel"], head["bias"]
    C, extra = kernel.shape[0], cfg.num_sep_tokens
    new_w = 0.02 * _trunc_normal_2sd(generator, (C, extra), float(np.sqrt(1.0 / C / 3.0)))
    return {"kernel": torch.cat([kernel, new_w.to(kernel)], dim=1),
            "bias": torch.cat([bias, bias.new_zeros(extra)])}


def var_to_control_var(var_params: Params, fresh_control_params: Params,
                       cfg: ControlVARConfig, mode: Literal["concat", "interpos"] = "concat",
                       mpos: bool = False, seed: int = 0) -> Params:
    """Merge a converted VAR checkpoint into a fresh ControlVAR param tree.
    Fresh slots (separator positions and head columns) come from a
    generator seeded with `seed`. The result shares no tensor with either
    input, so training it leaves both as they were."""
    if cfg.mask_factor != 2:
        raise ValueError("surgery is defined for interleave_append (mask_factor 2)")
    if cfg.cos_attn and "scale_mul" not in var_params["blocks"]:
        # the JAX package grafts such a tree and fails at its first forward
        raise ValueError("surgery into a cos_attn ControlVAR needs the VAR tree's "
                         "blocks/scale_mul, which a VAR built without cos_attn lacks")
    g = generator_for(seed)
    out = dict(fresh_control_params)
    for name in ("word_embed", "class_emb", "lvl_embed", "blocks", "head_nm"):
        out[name] = var_params[name]
    out["pos_1LC"] = expand_pos_1LC(var_params["pos_1LC"], cfg, mode, mpos, g)
    out["head"] = pad_head_for_separators(var_params["head"], cfg, g)
    # pos_start / cond_embed / type_embed / special_embed stay freshly
    # initialized (the reference drops pos_start from the state dict, :486)
    return tree_map(lambda t: t.detach().clone(), out)
