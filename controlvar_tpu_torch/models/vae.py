"""VQVAE conv backbone (LDM vq-f16 encoder and decoder).

ResNet blocks (GroupNorm32 + SiLU), single-head spatial attention at the
lowest resolution and mid, nearest+conv upsampling, asymmetric-pad stride-2
downsampling. The public functions take and return NHWC tensors, as the JAX
package does; inside they run NCHW, PyTorch's convolution layout (the NHWC
input permuted to NCHW is a channels-last view, which cuDNN takes as is).

`compute_dtype=torch.bfloat16` runs the convs in bf16; `float32` runs them
with TF32 off (the counterpart of `Precision.HIGHEST`). GroupNorm statistics
are always fp32.

Params: nested dicts of OIHW conv kernels {"kernel", "bias"} and GroupNorm
affines {"scale", "bias"}; see init_encoder_params/init_decoder_params.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from controlvar_tpu_torch.config import VQVAEConfig
from controlvar_tpu_torch.device import no_tf32
from controlvar_tpu_torch.ops.resize import upsample_nearest_2x

Params = Dict


def precision_scope(compute_dtype: torch.dtype):
    """fp32 compute runs without TF32; bf16 compute needs no guard."""
    return no_tf32() if compute_dtype == torch.float32 else contextlib.nullcontext()


# ----------------------------------------------------------------------------
# primitives (NCHW)
# ----------------------------------------------------------------------------

def _conv(p: Params, x: torch.Tensor, stride: int = 1, padding=None) -> torch.Tensor:
    w = p["kernel"].to(x.dtype)
    if padding is None:  # "SAME" for the odd kernels used here
        padding = w.shape[-1] // 2
    return F.conv2d(x, w, p["bias"].to(x.dtype), stride=stride, padding=padding)


def group_norm(p: Params, x: torch.Tensor, num_groups: int = 32,
               eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over NCHW with fp32 statistics, cast back to x's dtype."""
    y = F.group_norm(x.float(), num_groups, p["scale"].float(), p["bias"].float(), eps)
    return y.to(x.dtype)


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _resblock(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = _conv(p["conv1"], _swish(group_norm(p["norm1"], x)))
    h = _conv(p["conv2"], _swish(group_norm(p["norm2"], h)))
    if "nin_shortcut" in p:
        x = _conv(p["nin_shortcut"], x)
    return x + h


def _attnblock(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Single-head spatial self-attention. qkv is packed channel-major
    (B, 3C, H, W): q, k, v are channels [0,C), [C,2C), [2C,3C)."""
    B, C, H, W = x.shape
    qkv = _conv(p["qkv"], group_norm(p["norm"], x)).reshape(B, 3, C, H * W)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]             # (B, C, HW)
    w = torch.einsum("bci,bcj->bij", q, k) * (C ** -0.5)
    w = torch.softmax(w.float(), dim=-1).to(x.dtype)
    h = torch.einsum("bij,bcj->bci", w, v).reshape(B, C, H, W)
    return x + _conv(p["proj"], h)


# ----------------------------------------------------------------------------
# encoder / decoder (NHWC in and out)
# ----------------------------------------------------------------------------

def encoder_apply(p: Params, x: torch.Tensor, cfg: VQVAEConfig,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """img (B, H, W, 3) in [-1, 1] -> feature (B, H/16, W/16, z_channels)."""
    with precision_scope(compute_dtype):
        h = _conv(p["conv_in"], x.to(compute_dtype).permute(0, 3, 1, 2))
        n_lvl = len(cfg.ch_mult)
        for i_level in range(n_lvl):
            lvl = p["down"][i_level]
            for i_block in range(cfg.num_res_blocks):
                h = _resblock(lvl["block"][i_block], h)
                if lvl.get("attn"):
                    h = _attnblock(lvl["attn"][i_block], h)
            if i_level != n_lvl - 1:
                # stride-2 conv after an asymmetric pad: bottom and right by 1
                h = _conv(lvl["downsample"], F.pad(h, (0, 1, 0, 1)), stride=2,
                          padding=0)
        h = _resblock(p["mid"]["block_1"], h)
        h = _attnblock(p["mid"]["attn_1"], h)
        h = _resblock(p["mid"]["block_2"], h)
        h = _conv(p["conv_out"], _swish(group_norm(p["norm_out"], h)))
    return h.permute(0, 2, 3, 1)


def decoder_apply(p: Params, z: torch.Tensor, cfg: VQVAEConfig,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """feature (B, h, w, z_channels) -> img (B, 16h, 16w, 3), the literal
    upsample-then-conv decoder."""
    with precision_scope(compute_dtype):
        h = _conv(p["conv_in"], z.to(compute_dtype).permute(0, 3, 1, 2))
        h = _resblock(p["mid"]["block_1"], h)
        h = _attnblock(p["mid"]["attn_1"], h)
        h = _resblock(p["mid"]["block_2"], h)
        for i_level in reversed(range(len(cfg.ch_mult))):
            lvl = p["up"][i_level]
            for i_block in range(cfg.num_res_blocks + 1):
                h = _resblock(lvl["block"][i_block], h)
                if lvl.get("attn"):
                    h = _attnblock(lvl["attn"][i_block], h)
            if i_level != 0:
                h = _conv(lvl["upsample"], upsample_nearest_2x(h))
        h = _conv(p["conv_out"], _swish(group_norm(p["norm_out"], h)))
    return h.permute(0, 2, 3, 1)


# ----------------------------------------------------------------------------
# init (torch-default initializers)
# ----------------------------------------------------------------------------

def _init_conv(g: torch.Generator, kh, kw, cin, cout) -> Params:
    bound = 1.0 / np.sqrt(kh * kw * cin)
    return {
        "kernel": (torch.rand(cout, cin, kh, kw, generator=g) * 2 - 1) * bound,
        "bias": (torch.rand(cout, generator=g) * 2 - 1) * bound,
    }


def _init_norm(c) -> Params:
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def _init_resblock(g, cin, cout) -> Params:
    p = {
        "norm1": _init_norm(cin),
        "conv1": _init_conv(g, 3, 3, cin, cout),
        "norm2": _init_norm(cout),
        "conv2": _init_conv(g, 3, 3, cout, cout),
    }
    if cin != cout:
        p["nin_shortcut"] = _init_conv(g, 1, 1, cin, cout)
    return p


def _init_attn(g, c) -> Params:
    return {
        "norm": _init_norm(c),
        "qkv": _init_conv(g, 1, 1, c, 3 * c),
        "proj": _init_conv(g, 1, 1, c, c),
    }


def init_encoder_params(g: torch.Generator, cfg: VQVAEConfig) -> Params:
    ch = cfg.ch
    n_lvl = len(cfg.ch_mult)
    p: Params = {"conv_in": _init_conv(g, 3, 3, 3, ch)}
    in_mult = (1,) + tuple(cfg.ch_mult)
    down = []
    block_in = ch
    for i_level in range(n_lvl):
        block_in = ch * in_mult[i_level]
        block_out = ch * cfg.ch_mult[i_level]
        blocks, attns = [], []
        for _ in range(cfg.num_res_blocks):
            blocks.append(_init_resblock(g, block_in, block_out))
            block_in = block_out
            if i_level == n_lvl - 1:
                attns.append(_init_attn(g, block_in))
        lvl: Params = {"block": blocks, "attn": attns}
        if i_level != n_lvl - 1:
            lvl["downsample"] = _init_conv(g, 3, 3, block_in, block_in)
        down.append(lvl)
    p["down"] = down
    p["mid"] = {
        "block_1": _init_resblock(g, block_in, block_in),
        "attn_1": _init_attn(g, block_in),
        "block_2": _init_resblock(g, block_in, block_in),
    }
    p["norm_out"] = _init_norm(block_in)
    p["conv_out"] = _init_conv(g, 3, 3, block_in, cfg.z_channels)
    return p


def init_decoder_params(g: torch.Generator, cfg: VQVAEConfig) -> Params:
    ch = cfg.ch
    n_lvl = len(cfg.ch_mult)
    block_in = ch * cfg.ch_mult[n_lvl - 1]
    p: Params = {"conv_in": _init_conv(g, 3, 3, cfg.z_channels, block_in)}
    p["mid"] = {
        "block_1": _init_resblock(g, block_in, block_in),
        "attn_1": _init_attn(g, block_in),
        "block_2": _init_resblock(g, block_in, block_in),
    }
    up: list = [None] * n_lvl
    for i_level in reversed(range(n_lvl)):
        block_out = ch * cfg.ch_mult[i_level]
        blocks, attns = [], []
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(_init_resblock(g, block_in, block_out))
            block_in = block_out
            if i_level == n_lvl - 1:
                attns.append(_init_attn(g, block_in))
        lvl: Params = {"block": blocks, "attn": attns}
        if i_level != 0:
            lvl["upsample"] = _init_conv(g, 3, 3, block_in, block_in)
        up[i_level] = lvl
    p["up"] = up
    p["norm_out"] = _init_norm(block_in)
    p["conv_out"] = _init_conv(g, 3, 3, block_in, 3)
    return p
