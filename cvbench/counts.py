"""Operations and bytes as functions of shapes only, and the H100's peaks.

A kernel's roofline bound is the larger of its bytes over the peak bandwidth
and its operations over the peak rate: inputs read once, outputs written
once, whatever the kernel reads again; operations those the algorithm needs
(the unmasked scores of attention). Copied from `chip_smoke.py` (`bound_ms`,
`_k1_times`, `_flash_times`, the K2 count of `k2_phase`) and PERF.md's
kernel table, so that the counts stay valid whatever kernel later does the
work. Model FLOPs count 2 per multiply-add of the transformer (its weight
products, attention's two products, the head) and of the tokenizer's
convolutions and attention; a training step counts its forward three times
(forward, and a backward of twice the forward), without the recompute of
the remat policy.

`m` is a configuration's "model" dict, `v` its "vqvae" dict.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor cores (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12     # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3


def bound_s(nbytes: float, ops: float, peak_ops: float = PEAK_BF16_FLOPS) -> float:
    """The least time of a kernel: bytes or operations, whichever bounds."""
    return max(nbytes / PEAK_BYTES, ops / peak_ops)


def scales(m: Dict) -> List[Tuple[int, int, int]]:
    """(l, lo, hi) of each scale of the interleaved sequence: its 2 pn^2
    positions [lo, hi)."""
    out, cur = [], 0
    for p in m["patch_nums"]:
        l = 2 * p * p
        out.append((l, cur, cur + l))
        cur += l
    return out


def seq_len(m: Dict) -> int:
    return scales(m)[-1][2]


def unmasked_pairs(m: Dict) -> int:
    """(query, key) pairs the block-causal mask keeps: a query of scale i
    attends every key of the scales up to i."""
    return sum(l * hi for l, _, hi in scales(m))


# ---- kernels ----------------------------------------------------------------------


def k1_bound_s(m: Dict, rows: int) -> float:
    """K1 decode attention over one call of the conditional sampler: depth x
    scales launches on q (rows, H, l, hd) over cache rows [0, hi), bf16 q,
    out, K and V; 4 FLOP.hd per score."""
    C, H = m["embed_dim"], m["num_heads"]
    hd = C // H
    total = 0.0
    for l, _, hi in scales(m):
        nbytes = 2 * (2 * rows * H * l * hd + 2 * rows * H * hi * hd)
        total += bound_s(nbytes, 4 * rows * H * l * hi * hd)
    return m["depth"] * total


def k2_bound_s(m: Dict, batch: int) -> float:
    """K2 bisection sampling over one call: a launch a scale on the forced
    group's free half and the uncond group's both halves, batch x 3 pn^2
    rows of V fp32 logits read once and int64 ids written. Per logit the
    max, the two filters' compares and x - m and its exp (5 fp32
    operations); the work per kept logit depends on the draw and is not
    counted, so the bound is a floor."""
    V = m["vocab_size"]
    total = 0.0
    for p in m["patch_nums"]:
        n = batch * 3 * p * p
        total += bound_s(4 * n * V + 8 * n, 5 * n * V, PEAK_FP32_FLOPS)
    return total


def _flash_sizes(m: Dict, batch: int):
    C, H = m["embed_dim"], m["num_heads"]
    hd, L = C // H, seq_len(m)
    n = batch * H * L * hd
    per_score = batch * H * hd * unmasked_pairs(m)
    return n, batch * H * L, L, per_score


def k3_bound_s(m: Dict, batch: int) -> float:
    """One K3 launch (flash attention forward) at the training shape: q, k, v
    and out in bf16, the fp32 LSE, the (L, L) mask; 4 FLOP.hd per unmasked
    score."""
    n, rows, L, per_score = _flash_sizes(m, batch)
    return bound_s(2 * 4 * n + 4 * rows + L * L, 4 * per_score)


def k4_bound_s(m: Dict, batch: int) -> float:
    """One K4 launch (flash attention backward): q, k, v, out, dO, dq, dk and
    dv in bf16, the LSE, the mask; 10 FLOP.hd per unmasked score."""
    n, rows, L, per_score = _flash_sizes(m, batch)
    return bound_s(2 * 8 * n + 4 * rows + L * L, 10 * per_score)


# ---- model FLOPs ----------------------------------------------------------------------


def transformer_forward_flops(m: Dict, rows: int, head_rows: int) -> float:
    """One forward of the transformer over `rows` full sequences, the vocab
    head over `head_rows` of them (the CFG combine precedes the head)."""
    C, D, V, L = m["embed_dim"], m["depth"], m["vocab_size"], seq_len(m)
    hidden = round(C * m["mlp_ratio"])
    per_token = D * 2 * (3 * C * C + C * C + 2 * C * hidden) + 2 * m["cvae"] * C
    per_row = (L * per_token + D * 4 * C * unmasked_pairs(m)     # attention's two products
               + D * 2 * C * 6 * C + 2 * C * 2 * C)              # AdaLN, once a row
    return rows * per_row + head_rows * L * 2 * C * V


def _conv(cin: int, cout: int, k: int, hw: int) -> float:
    return 2.0 * cin * cout * k * k * hw * hw


def _resblock(cin: int, cout: int, hw: int) -> float:
    f = _conv(cin, cout, 3, hw) + _conv(cout, cout, 3, hw)
    return f + (_conv(cin, cout, 1, hw) if cin != cout else 0.0)


def _attnblock(c: int, hw: int) -> float:
    n = hw * hw
    return _conv(c, 3 * c, 1, hw) + _conv(c, c, 1, hw) + 4.0 * n * n * c


def vqvae_encode_flops(v: Dict, image_size: int) -> float:
    """One image through the encoder and quant_conv."""
    ch, mult, nrb, z = v["ch"], v["ch_mult"], v["num_res_blocks"], v["z_channels"]
    hw, f = image_size, _conv(3, ch, 3, image_size)
    cin = ch
    for i, mu in enumerate(mult):
        for _ in range(nrb):
            f += _resblock(cin, ch * mu, hw)
            cin = ch * mu
            if i == len(mult) - 1:
                f += _attnblock(cin, hw)
        if i != len(mult) - 1:
            hw //= 2
            f += _conv(cin, cin, 3, hw)
    f += 2 * _resblock(cin, cin, hw) + _attnblock(cin, hw)
    return f + _conv(cin, z, 3, hw) + _conv(z, z, v["quant_conv_ks"], hw)


def vqvae_decode_flops(v: Dict, image_size: int) -> float:
    """One image through post_quant_conv and the decoder."""
    ch, mult, nrb, z = v["ch"], v["ch_mult"], v["num_res_blocks"], v["z_channels"]
    hw = image_size // 2 ** (len(mult) - 1)
    cin = ch * mult[-1]
    f = _conv(z, z, v["quant_conv_ks"], hw) + _conv(z, cin, 3, hw)
    f += 2 * _resblock(cin, cin, hw) + _attnblock(cin, hw)
    for i in reversed(range(len(mult))):
        for _ in range(nrb + 1):
            f += _resblock(cin, ch * mult[i], hw)
            cin = ch * mult[i]
            if i == len(mult) - 1:
                f += _attnblock(cin, hw)
        if i != 0:
            hw *= 2
            f += _conv(cin, cin, 3, hw)
    return f + _conv(cin, 3, 3, hw)


def cond_call_flops(m: Dict, v: Dict, batch: int, branches: int = 4) -> float:
    """One control-conditioned call: the control images encoded, the
    transformer over batch x branches rows (decode through the cache does
    the full forward's work), the head over the combined rows, the
    generated images decoded."""
    size = v["image_size"]
    return (transformer_forward_flops(m, batch * branches, batch)
            + batch * (vqvae_encode_flops(v, size) + vqvae_decode_flops(v, size)))


def train_step_flops(m: Dict, v: Dict, batch: int) -> float:
    """One training step: both images of each sample encoded (no gradient),
    the transformer's forward and backward (three forwards' work)."""
    size = v["image_size"]
    return (3 * transformer_forward_flops(m, batch, batch)
            + 2 * batch * vqvae_encode_flops(v, size))
