"""The multi-scale VQVAE of VAR (FoundationVision/VAR models/basic_vae.py,
quant.py): the LDM vq-f16 encoder and decoder, and the residual quantizer
over a pyramid of token maps with four partially shared phi convs.

Images and features are NHWC at the boundary, NCHW inside. `v` is a
configuration's "vqvae" dict; `p` the tree of `cvbench/weights.py`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from cvbench.reference.prec import Prec


def _norm(p, x):
    return F.group_norm(x, 32, p["scale"], p["bias"], eps=1e-6)


def _resblock(p, x, prec: Prec):
    h = prec.conv(F.silu(_norm(p["norm1"], x)), p["conv1"])
    h = prec.conv(F.silu(_norm(p["norm2"], h)), p["conv2"])
    if "nin_shortcut" in p:
        x = prec.conv(x, p["nin_shortcut"])
    return x + h


def _attnblock(p, x, prec: Prec):
    B, C, H, W = x.shape
    q, k, v = prec.conv(_norm(p["norm"], x), p["qkv"]).reshape(B, 3, C, H * W).unbind(1)
    w = torch.softmax(torch.bmm(q.transpose(1, 2), k) * C ** -0.5, dim=-1)   # (B, HW, HW)
    h = torch.bmm(v, w.transpose(1, 2)).reshape(B, C, H, W)
    return x + prec.conv(h, p["proj"])


def encode(p: Dict, img: torch.Tensor, v: Dict, prec: Prec) -> torch.Tensor:
    """img (N, H, W, 3) in [-1, 1] -> the quant_conv feature (N, H/16, W/16, z)."""
    e = p["encoder"]
    h = prec.conv(img.float().permute(0, 3, 1, 2), e["conv_in"])
    n = len(v["ch_mult"])
    for i in range(n):
        lvl = e["down"][i]
        for j in range(v["num_res_blocks"]):
            h = _resblock(lvl["block"][j], h, prec)
            if lvl["attn"]:
                h = _attnblock(lvl["attn"][j], h, prec)
        if i != n - 1:
            h = prec.conv(F.pad(h, (0, 1, 0, 1)), lvl["downsample"], stride=2, padding=0)
    h = _resblock(e["mid"]["block_1"], h, prec)
    h = _attnblock(e["mid"]["attn_1"], h, prec)
    h = _resblock(e["mid"]["block_2"], h, prec)
    h = prec.conv(F.silu(_norm(e["norm_out"], h)), e["conv_out"])
    return prec.conv(h, p["quant_conv"]).permute(0, 2, 3, 1)


def decode(p: Dict, f_hat: torch.Tensor, v: Dict, prec: Prec) -> torch.Tensor:
    """f_hat (N, h, w, z) -> image (N, 16h, 16w, 3) clamped to [-1, 1]."""
    d = p["decoder"]
    h = prec.conv(f_hat.float().permute(0, 3, 1, 2), p["post_quant_conv"])
    h = prec.conv(h, d["conv_in"])
    h = _resblock(d["mid"]["block_1"], h, prec)
    h = _attnblock(d["mid"]["attn_1"], h, prec)
    h = _resblock(d["mid"]["block_2"], h, prec)
    for i in reversed(range(len(v["ch_mult"]))):
        lvl = d["up"][i]
        for j in range(v["num_res_blocks"] + 1):
            h = _resblock(lvl["block"][j], h, prec)
            if lvl["attn"]:
                h = _attnblock(lvl["attn"][j], h, prec)
        if i != 0:
            h = prec.conv(F.interpolate(h, scale_factor=2, mode="nearest"), lvl["upsample"])
    h = prec.conv(F.silu(_norm(d["norm_out"], h)), d["conv_out"])
    return h.permute(0, 2, 3, 1).clamp(-1.0, 1.0)


# ---- the residual quantizer ---------------------------------------------------

def _phi_index(si: int, num_scales: int, num_phi: int) -> int:
    """quant.py's PhiPartiallyShared: K phis at ticks over [0, 1], scale si
    takes the tick nearest si / (S - 1)."""
    K = num_phi
    ticks = (np.linspace(1 / 3 / K, 1 - 1 / 3 / K, K) if K == 4
             else np.linspace(1 / 2 / K, 1 - 1 / 2 / K, K))
    return int(np.argmin(np.abs(ticks - si / (num_scales - 1))))


def _phi(p: Dict, si: int, h: torch.Tensor, v: Dict) -> torch.Tensor:
    """phi(h) = (1 - r) h + r conv3x3(h) on NCHW, r = quant_resi."""
    S, r = len(v["patch_nums"]), v["quant_resi"]
    conv = p["quantize"]["phi"][_phi_index(si, S, v["share_quant_resi"])]
    return h * (1 - r) + F.conv2d(h, conv["kernel"], conv["bias"], padding=1) * r


def _up(p: Dict, si: int, ids: torch.Tensor, v: Dict) -> torch.Tensor:
    """Scale si's ids (N, pn^2) -> phi(bicubic(embedding)) (N, z, H, H)."""
    pns = v["patch_nums"]
    pn, H = pns[si], pns[-1]
    h = p["quantize"]["embedding"][ids].reshape(-1, pn, pn, v["z_channels"]).permute(0, 3, 1, 2)
    if pn != H:
        h = F.interpolate(h, size=(H, H), mode="bicubic", align_corners=False)
    return _phi(p, si, h, v)


def _dist(p: Dict, z: torch.Tensor) -> torch.Tensor:
    """Squared distances (M, V) of feature rows z (M, z) to the codebook."""
    E = p["quantize"]["embedding"]
    return (z * z).sum(-1, keepdim=True) + (E * E).sum(-1)[None] - 2.0 * z @ E.T


def code_gaps(p: Dict, f: torch.Tensor, ids: Sequence[torch.Tensor], v: Dict,
              chain: Optional[Sequence[torch.Tensor]] = None) -> float:
    """The tokenizer's choices `ids` (per scale (N, pn^2)) judged against
    features f (N, H, H, z), scale by scale along the residual chain that
    the ids `chain` leave (`ids` themselves by default): the widest
    squared distance of a chosen code above the nearest one's, over the
    median nearest distance of all positions."""
    chain = ids if chain is None else chain
    pns = v["patch_nums"]
    rest = f.float().permute(0, 3, 1, 2)
    gaps, best = [], []
    for si, pn in enumerate(pns):
        z = rest if pn == pns[-1] else F.interpolate(rest, size=(pn, pn), mode="area")
        d = _dist(p, z.permute(0, 2, 3, 1).reshape(-1, z.shape[1]))
        chosen = d.gather(1, ids[si].reshape(-1, 1).long())[:, 0]
        dmin = d.min(dim=1).values
        gaps.append(chosen - dmin)
        best.append(dmin)
        rest = rest - _up(p, si, chain[si], v)
    scale = torch.cat(best).median().clamp_min(1e-12)
    return float(torch.cat(gaps).max() / scale)


def nearest_ids(p: Dict, f: torch.Tensor, v: Dict,
                chain: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
    """At each scale, the nearest code to features f (N, H, H, z) along the
    residual chain that the ids `chain` leave, or by default its own
    choices (tokenizing)."""
    pns = v["patch_nums"]
    rest = f.float().permute(0, 3, 1, 2)
    out = []
    for si, pn in enumerate(pns):
        z = rest if pn == pns[-1] else F.interpolate(rest, size=(pn, pn), mode="area")
        d = _dist(p, z.permute(0, 2, 3, 1).reshape(-1, z.shape[1]))
        out.append(d.argmin(dim=1).reshape(f.shape[0], pn * pn))
        rest = rest - _up(p, si, out[-1] if chain is None else chain[si], v)
    return out


def fhat_from_ids(p: Dict, ids: Sequence[torch.Tensor], v: Dict) -> torch.Tensor:
    """The f_hat (N, H, H, z) that per-scale ids add up to."""
    f_hat = sum(_up(p, si, t, v) for si, t in enumerate(ids))
    return f_hat.permute(0, 2, 3, 1)


def teacher_inputs(p: Dict, ids: Sequence[torch.Tensor], v: Dict) -> List[torch.Tensor]:
    """Scale k's input (k = 1 .. S-1): the f_hat of scales < k area-resized
    to (pn_k, pn_k), as (N, pn_k^2, z)."""
    pns = v["patch_nums"]
    f_hat, out = 0.0, []
    for si in range(len(pns) - 1):
        f_hat = f_hat + _up(p, si, ids[si], v)
        nxt = F.interpolate(f_hat, size=(pns[si + 1],) * 2, mode="area")
        out.append(nxt.permute(0, 2, 3, 1).reshape(nxt.shape[0], -1, v["z_channels"]))
    return out
