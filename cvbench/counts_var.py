"""Operations and bytes of a plain VAR sampling call, from shapes only
(`counts.py` counts ControlVAR's interleaved sequence of 2 pn^2 positions a
scale; VAR's one stream has pn^2).

A call at batch B runs the blocks over 2 B CFG rows [cond | uncond], the
CFG-combined head over B rows, one K2 launch a scale over the B pn^2
combined rows, and the VQVAE decode of the B images; it tokenizes nothing.
Shared AdaLN makes one C -> 6C modulation a row for the whole model.

`m` is a configuration's "model" dict, `v` its "vqvae" dict.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from cvbench.counts import PEAK_FP32_FLOPS, bound_s, vqvae_decode_flops


def scales(m: Dict) -> List[Tuple[int, int, int]]:
    """(l, lo, hi) of each scale: its pn^2 positions [lo, hi)."""
    out, cur = [], 0
    for p in m["patch_nums"]:
        out.append((p * p, cur, cur + p * p))
        cur += p * p
    return out


def seq_len(m: Dict) -> int:
    return scales(m)[-1][2]


def unmasked_pairs(m: Dict) -> int:
    """(query, key) pairs of the block-causal mask: a query of scale i
    attends every key of the scales up to i."""
    return sum(l * hi for l, _, hi in scales(m))


def k1_bound_s(m: Dict, rows: int) -> float:
    """K1 over one call: depth x scales launches on q (rows, H, l, hd) over
    cache rows [0, hi), bf16 q, out, K and V read and written once; 4
    FLOP.hd per score."""
    C, H = m["embed_dim"], m["num_heads"]
    hd = C // H
    total = 0.0
    for l, _, hi in scales(m):
        nbytes = 2 * (2 * rows * H * l * hd + 2 * rows * H * hi * hd)
        total += bound_s(nbytes, 4 * rows * H * l * hi * hd)
    return m["depth"] * total


def k2_bound_s(m: Dict, batch: int) -> float:
    """K2 over one call: a launch a scale on batch x pn^2 rows of V fp32
    combined logits read once and int64 ids written; 5 fp32 operations a
    logit (a floor: the kept set's work is not counted, as in
    `counts.k2_bound_s`)."""
    V = m["vocab_size"]
    total = 0.0
    for l, _, _ in scales(m):
        n = batch * l
        total += bound_s(4 * n * V + 8 * n, 5 * n * V, PEAK_FP32_FLOPS)
    return total


def var_forward_flops(m: Dict, rows: int, head_rows: int) -> float:
    """One forward of the blocks over `rows` full sequences, the vocabulary
    head over `head_rows` of them: the weight products, attention's two
    products over the unmasked pairs, the shared AdaLN and the head's
    AdaLN once a row, 2 per multiply-add."""
    C, D, V, L = m["embed_dim"], m["depth"], m["vocab_size"], seq_len(m)
    hidden = round(C * m["mlp_ratio"])
    per_token = D * 2 * (3 * C * C + C * C + 2 * C * hidden) + 2 * m["cvae"] * C
    per_row = (L * per_token + D * 4 * C * unmasked_pairs(m)
               + 2 * C * 6 * C + 2 * C * 2 * C)
    return rows * per_row + head_rows * L * 2 * C * V


def var_call_flops(m: Dict, v: Dict, batch: int) -> float:
    """One class-conditional call: the blocks over 2 batch CFG rows, the
    head over batch combined rows, the batch images decoded."""
    return (var_forward_flops(m, 2 * batch, batch)
            + batch * vqvae_decode_flops(v, v["image_size"]))
