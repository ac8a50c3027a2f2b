"""AdaLN self-attention transformer, decode subset.

One block type: pre-norm (no affine) with per-condition (gamma1, gamma2,
scale1, scale2, shift1, shift2) modulation, fused QKV with a zero k bias,
1/(sqrt(hd)*tau) scaling or cosine attention, GELU(tanh) MLP. The residual
stream runs in the compute dtype (bf16 on the GPU); LayerNorm statistics,
AdaLN modulation and softmax run in fp32.

Decode keeps a preallocated (depth, B, H, L_max, hd) K/V cache per stream,
written in place: each layer-step writes its fresh rows [pos, pos + l) and
attention (ops/attention.decode_attention, kernel K1 on the GPU) reads rows
[0, pos + l) of that layer through strides, with no copy of the prefix.

Stacked params (leading dim = depth), dense kernels as (in, out):
  qkv_kernel (D, C, 3C)   q_bias/v_bias (D, C)
  proj{kernel (D,C,C), bias (D,C)}   fc1{(D,C,hidden)}  fc2{(D,hidden,C)}
  ada_lin{kernel (D, C, 6C), bias (D, 6C)}   scale_mul (D, H) [cos_attn only]
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from controlvar_tpu_torch.config import VARConfig
from controlvar_tpu_torch.ops.attention import decode_attention

Params = Dict

MAX_COS_SCALE = float(np.log(100.0))


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-free LayerNorm with fp32 statistics, cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _trunc_normal(g: torch.Generator, shape, std: float) -> torch.Tensor:
    """torch.nn.init.trunc_normal_(std=s): truncation at ABSOLUTE +-2, which
    for the small stds used here is a plain normal in practice."""
    if 2.0 / std >= 10.0:
        return std * torch.randn(*shape, generator=g)
    t = torch.empty(*shape)
    return torch.nn.init.trunc_normal_(t, std=std, a=-2.0, b=2.0, generator=g)


def init_block_params(g: torch.Generator, cfg: VARConfig) -> Params:
    """Reference defaults with the depth-scaled special init."""
    if cfg.shared_aln:
        raise NotImplementedError("shared_aln is not ported yet")
    C, D = cfg.embed_dim, cfg.depth
    hidden = round(C * cfg.mlp_ratio)
    std = 0.02
    p: Params = {
        "qkv_kernel": _trunc_normal(g, (D, C, 3 * C), std),
        "q_bias": torch.zeros(D, C),
        "v_bias": torch.zeros(D, C),
        "proj": {"kernel": _trunc_normal(g, (D, C, C), std) / np.sqrt(2 * D),
                 "bias": torch.zeros(D, C)},
        "fc1": {"kernel": _trunc_normal(g, (D, C, hidden), std),
                "bias": torch.zeros(D, hidden)},
        "fc2": {"kernel": _trunc_normal(g, (D, hidden, C), std) / np.sqrt(2 * D),
                "bias": torch.zeros(D, C)},
    }
    w = _trunc_normal(g, (D, C, 6 * C), std)
    w[:, :, : 2 * C] *= cfg.aln_gamma_init   # gamma columns
    w[:, :, 2 * C:] *= cfg.aln_init          # scale/shift columns
    p["ada_lin"] = {"kernel": w, "bias": torch.zeros(D, 6 * C)}
    if cfg.cos_attn:
        p["scale_mul"] = torch.full((D, cfg.num_heads), float(np.log(4.0)))
    return p


def init_head_params(g: torch.Generator, cfg: VARConfig, head_vocab: int) -> Params:
    C = cfg.embed_dim
    return {
        "head_nm": {"ada_lin": {"kernel": _trunc_normal(g, (C, 2 * C), 0.02) * cfg.aln_init,
                                "bias": torch.zeros(2 * C)}},
        "head": {"kernel": _trunc_normal(g, (C, head_vocab), 0.02),
                 "bias": torch.zeros(head_vocab)},
    }


def _layer(bp: Params, li: int) -> Params:
    """Layer li's views of the stacked block params."""
    return {k: (_layer(v, li) if isinstance(v, dict) else v[li]) for k, v in bp.items()}


def _qkv(lp: Params, x: torch.Tensor, cfg: VARConfig):
    """x (B, L, C) -> q, k, v each (B, H, L, hd); cos-attn normalization applied."""
    B, L, C = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    bias = torch.cat([lp["q_bias"], torch.zeros_like(lp["q_bias"]), lp["v_bias"]], dim=-1)
    qkv = x @ lp["qkv_kernel"].to(x.dtype) + bias.to(x.dtype)
    q, k, v = qkv.reshape(B, L, 3, H, hd).permute(2, 0, 3, 1, 4)  # (3, B, H, L, hd)
    if cfg.cos_attn:
        sm = torch.exp(torch.clamp(lp["scale_mul"].float(), max=MAX_COS_SCALE))
        qf, kf = q.float(), k.float()
        q = (qf / qf.norm(dim=-1, keepdim=True).clamp_min(1e-12)
             * sm[None, :, None, None]).to(x.dtype)
        k = (kf / kf.norm(dim=-1, keepdim=True).clamp_min(1e-12)).to(x.dtype)
    return q, k, v


def _ffn(lp: Params, x: torch.Tensor) -> torch.Tensor:
    h = x @ lp["fc1"]["kernel"].to(x.dtype) + lp["fc1"]["bias"].to(x.dtype)
    h = F.gelu(h, approximate="tanh")
    return h @ lp["fc2"]["kernel"].to(x.dtype) + lp["fc2"]["bias"].to(x.dtype)


def _ada_all_layers(bp: Params, cond_act: torch.Tensor, cfg: VARConfig) -> torch.Tensor:
    """(depth, B, 6, C) AdaLN modulations of all layers in one batched matmul,
    in the kernel's dtype (bf16 after prepare_params), then fp32."""
    k_ada = bp["ada_lin"]["kernel"]
    ada = torch.einsum("bc,dce->dbe", cond_act.to(k_ada.dtype), k_ada).float()
    ada = ada + bp["ada_lin"]["bias"].float()[:, None]
    return ada.reshape(cfg.depth, -1, 6, cfg.embed_dim)


def _decode_block_body(lp: Params, h: torch.Tensor, ada: torch.Tensor,
                       cfg: VARConfig, attn_fn) -> torch.Tensor:
    """Per-layer decode: AdaLN-modulated pre-norm -> fused QKV -> attention
    -> gamma-gated residual -> modulated FFN residual."""
    g1, g2, s1, s2, sh1, sh2 = (a.reshape(-1, 1, cfg.embed_dim)
                                for a in ada.unbind(dim=1))
    hn = layer_norm(h, cfg.norm_eps)
    hn = (hn.float() * (s1 + 1.0) + sh1).to(h.dtype)
    o = attn_fn(*_qkv(lp, hn, cfg))
    B, H, Lq, hd = o.shape
    o = o.transpose(1, 2).reshape(B, Lq, H * hd)
    o = o @ lp["proj"]["kernel"].to(o.dtype) + lp["proj"]["bias"].to(o.dtype)
    h = h + (o.float() * g1).to(h.dtype)
    hn = layer_norm(h, cfg.norm_eps)
    hn = (hn.float() * (s2 + 1.0) + sh2).to(h.dtype)
    f = _ffn(lp, hn)
    return h + (f.float() * g2).to(h.dtype)


def init_kv_cache(cfg: VARConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed K and V caches, each (depth, B, H, max_len, hd)."""
    shape = (cfg.depth, batch, cfg.num_heads, max_len, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def blocks_decode(bp: Params, x: torch.Tensor, cond: torch.Tensor, cfg: VARConfig,
                  cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                  mask_slice: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One KV-cached decode step over all blocks.

    x: (B, l, C) tokens of the current scale; pos: first cache row they take.
    mask_slice: optional (l, pos + l) bool mask; None = attend to everything
    cached. The caches are updated in place and returned.
    """
    l = x.shape[1]
    cur = pos + l
    ada_all = _ada_all_layers(bp, F.silu(cond.float()), cfg)
    scale = 1.0 if cfg.cos_attn else cfg.attn_scale
    for li in range(cfg.depth):
        def attn_fn(q, k, v, li=li):
            cache_k[li, :, :, pos:cur] = k
            cache_v[li, :, :, pos:cur] = v
            return decode_attention(q, cache_k, cache_v, li, cur, scale, mask_slice)

        x = _decode_block_body(_layer(bp, li), x, ada_all[li], cfg, attn_fn)
    return x, cache_k, cache_v


def head_logits_cfg(p: Params, x: torch.Tensor, cond: torch.Tensor,
                    cfg: VARConfig, weights) -> torch.Tensor:
    """CFG-combined head logits in one reduced matmul, fp32.

    x: (R*B, seg, C) final hidden states of the R CFG branches; weights: R
    floats summing to 1. The vocab projection is linear, so the branches are
    combined after the per-branch AdaLN-LN and before the C x V matmul."""
    assert abs(sum(weights) - 1.0) < 1e-6
    R = len(weights)
    B = x.shape[0] // R
    cond_act = F.silu(cond.float())
    ada = cond_act @ p["head_nm"]["ada_lin"]["kernel"] + p["head_nm"]["ada_lin"]["bias"]
    scale, shift = ada.reshape(-1, 2, cfg.embed_dim).split(1, dim=1)
    h = layer_norm(x.float(), cfg.norm_eps)
    h = h * (scale + 1.0) + shift                       # (R*B, seg, C)
    # python-float weights: no host->device copy (which would wait for the
    # GPU queue) in the middle of a scale step
    hc = sum(w * hr for w, hr in zip(weights, h.split(B)))
    return hc @ p["head"]["kernel"] + p["head"]["bias"]
