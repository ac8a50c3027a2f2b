"""Attention masks and index tables for scale-pyramid transformers (numpy).

Masks are boolean (True = may attend); the attention op turns them into a
large negative score.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from controlvar_tpu_torch.config import ControlVARConfig


def _seg_lens(patch_nums: Tuple[int, ...], separator: bool):
    """Per-scale segment length of ONE interleaved part (pn^2 + sep slot)."""
    return [pn * pn + (1 if (i != 0 and separator) else 0)
            for i, pn in enumerate(patch_nums)]


@functools.lru_cache(maxsize=None)
def level_index_1L(patch_nums: Tuple[int, ...], mask_factor: int = 1,
                   separator: bool = False) -> np.ndarray:
    """(L,) int32: scale index of every token."""
    segs = _seg_lens(patch_nums, separator)
    return np.concatenate(
        [np.full(seg * mask_factor, i, np.int32) for i, seg in enumerate(segs)]
    )


@functools.lru_cache(maxsize=None)
def type_index_1L(patch_nums: Tuple[int, ...], separator: bool = False,
                  mask_first: bool = True) -> np.ndarray:
    """(L,) int32 control/image type id of every token of a mask_factor 2
    sequence: (1, 0) a scale when mask_first, (0, 1) otherwise."""
    a, b = (1, 0) if mask_first else (0, 1)
    return np.concatenate([np.full(seg, t, np.int32)
                           for seg in _seg_lens(patch_nums, separator) for t in (a, b)])


@functools.lru_cache(maxsize=None)
def block_causal_mask(patch_nums: Tuple[int, ...], mask_factor: int = 1,
                      separator: bool = False) -> np.ndarray:
    """(L, L) bool: a query of scale i attends keys of scales <= i."""
    lvl = level_index_1L(patch_nums, mask_factor, separator)
    return lvl[:, None] >= lvl[None, :]


@functools.lru_cache(maxsize=None)
def separate_decoding_mask(patch_nums: Tuple[int, ...], separator: bool = False,
                           indep: bool = False) -> np.ndarray:
    """(L, L) bool mask of ControlVAR `separate_decoding`: control tokens of
    scale i do not see image tokens of scale i; with `indep` image tokens of
    scale i do not see control tokens of scale i either."""
    segs = _seg_lens(patch_nums, separator)
    d, dT = [], []
    for i, seg in enumerate(segs):
        d.extend([np.full(seg, 1 + 4 * i), np.full(seg, 3 + 4 * i)])
        dT.extend([np.full(seg, 1 + 4 * i), np.full(seg, 2 + 4 * i)])
    mask = np.concatenate(d)[:, None] >= np.concatenate(dT)[None, :]
    if indep:
        d2, dT2 = [], []
        for i, seg in enumerate(segs):
            d2.extend([np.full(seg, 3 + 4 * i), np.full(seg, 1 + 4 * i)])
            dT2.extend([np.full(seg, 2 + 4 * i), np.full(seg, 0 + 4 * i)])
        mask = mask & (np.concatenate(d2)[:, None] >= np.concatenate(dT2)[None, :])
    return mask


def attn_mask_for_config(cfg) -> np.ndarray:
    """The (L, L) attention mask the config calls for."""
    if isinstance(cfg, ControlVARConfig):
        if cfg.separate_decoding:
            return separate_decoding_mask(cfg.patch_nums, cfg.separator, cfg.indep)
        return block_causal_mask(cfg.patch_nums, cfg.mask_factor, cfg.separator)
    return block_causal_mask(cfg.patch_nums, 1, False)
