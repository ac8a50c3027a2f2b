"""ControlVAR (lxa9867/ControlVAR models/control_var.py over VAR's
basic_var.py): the teacher-forced forward over the interleaved sequence
[sos | control_1, image_1 | ... | control_S-1, image_S-1] under the
block-causal mask, its masked-free cross-entropy, and AdamW.

`m` is a configuration's "model" dict; `P` the tree of
`cvbench/weights.py` (dense kernels stored (in, out), block leaves stacked
over the depth). multi_cond: the sos pair is [cond-type embedding, class
embedding]; the AdaLN condition is the class embedding.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cvbench.reference.prec import Prec

COND_UNCOND = 4            # the dropped cond type's id under multi_cond
MAX_SCALE_MUL = math.log(100.0)


def level_index(m: Dict) -> torch.Tensor:
    return torch.cat([torch.full((2 * p * p,), i) for i, p in enumerate(m["patch_nums"])])


def scale_bounds(m: Dict):
    """[lo, hi) of each scale's 2 pn^2 positions."""
    out, cur = [], 0
    for p in m["patch_nums"]:
        out.append((cur, cur + 2 * p * p))
        cur += 2 * p * p
    return out


def _layer_norm(x, eps):
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def _block(P, li, x, cond, m, prec: Prec, mask, keep=None):
    """One AdaLNSelfAttn layer (basic_var.py): the six modulations of
    SiLU(cond), attention under `mask`, the gated residuals."""
    b = P["blocks"]
    N, L, C = x.shape
    H = m["num_heads"]
    hd = C // H
    ada = prec.linear(F.silu(cond), b["ada_lin"]["kernel"][li], b["ada_lin"]["bias"][li])
    g1, g2, s1, s2, sh1, sh2 = ada.reshape(N, 1, 6, C).unbind(2)
    h = _layer_norm(x, m["norm_eps"]) * (s1 + 1) + sh1
    bias = torch.cat([b["q_bias"][li], torch.zeros_like(b["q_bias"][li]), b["v_bias"][li]])
    q, k, v = prec.linear(h, b["qkv_kernel"][li], bias).reshape(N, L, 3, H, hd).permute(
        2, 0, 3, 1, 4)
    if m["cos_attn"]:
        sm = b["scale_mul"][li].clamp(max=MAX_SCALE_MUL).exp()[None, :, None, None]
        q, k, scale = F.normalize(q, dim=-1) * sm, F.normalize(k, dim=-1), 1.0
    else:
        scale = 1.0 / math.sqrt(hd) / m["tau"]
    s = (q @ k.transpose(-1, -2)) * scale
    s = s.masked_fill(~mask, float("-inf"))
    o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(N, L, C)
    o = prec.linear(o, b["proj"]["kernel"][li], b["proj"]["bias"][li]) * g1
    if keep is not None:
        o = o * keep[0][:, None, None]
    x = x + o
    h = _layer_norm(x, m["norm_eps"]) * (s2 + 1) + sh2
    h = F.gelu(prec.linear(h, b["fc1"]["kernel"][li], b["fc1"]["bias"][li]), approximate="tanh")
    f = prec.linear(h, b["fc2"]["kernel"][li], b["fc2"]["bias"][li]) * g2
    if keep is not None:
        f = f * keep[1][:, None, None]
    return x + f


def forward(P: Dict, m: Dict, labels: torch.Tensor, cond_type: torch.Tensor,
            x_tf: torch.Tensor, prec: Prec, keep: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Logits (N, L, V) of the teacher-forced sequence. x_tf (N, L - 2, z):
    the interleaved teacher-forcing features; keep: optional (D, 2, N) drop
    path factors of each layer's attention and FFN branches."""
    device = x_tf.device
    cond = P["class_emb"][labels]
    sos = torch.stack([P["cond_embed"][cond_type], cond], dim=1) + P["pos_start"]
    x = torch.cat([sos, prec.linear(x_tf, P["word_embed"]["kernel"], P["word_embed"]["bias"])],
                  dim=1)
    lvl = level_index(m).to(device)
    x = x + P["lvl_embed"][lvl][None] + P["pos_1LC"]
    mask = lvl[:, None] >= lvl[None, :]
    for li in range(m["depth"]):
        args = (P, li, x, cond, m, prec, mask, None if keep is None else keep[li])
        if torch.is_grad_enabled():
            # a layer's activations are recomputed in the backward: only its
            # input is kept, so the fp32 model fits beside its optimizer state
            x = checkpoint(_block, *args, use_reentrant=False)
        else:
            x = _block(*args)
    ada = prec.linear(F.silu(cond), P["head_nm"]["ada_lin"]["kernel"],
                      P["head_nm"]["ada_lin"]["bias"])
    scale, shift = ada.reshape(-1, 1, 2, x.shape[-1]).unbind(2)
    h = _layer_norm(x, m["norm_eps"]) * (scale + 1) + shift
    return prec.linear(h, P["head"]["kernel"], P["head"]["bias"])


def interleave(ctrl: Sequence[torch.Tensor], img: Sequence[torch.Tensor]) -> torch.Tensor:
    """[c_0, i_0, c_1, i_1, ...] along dim 1."""
    return torch.cat([t for pair in zip(ctrl, img) for t in pair], dim=1)


def cfg_weights(cfg_scales: Sequence[float], si: int, num_scales: int) -> List[float]:
    """The four CFG branches' weights at scale si: the guidance t ramps
    linearly over the scales; (1 + t1) a + (t2 - t1) b + (t3 - t2) c - t3 d."""
    t1, t2, t3 = (c * si / (num_scales - 1) for c in cfg_scales)
    return [1.0 + t1, t2 - t1, t3 - t2, -t3]


# ---- training -------------------------------------------------------------------

# no weight decay: embeddings, positions, biases, cos_attn scales and every
# leaf of at most one dimension (blocks: after the depth axis)
NO_DECAY = ("pos_1LC", "pos_start", "lvl_embed", "class_emb", "cond_embed", "scale_mul",
            "bias")


def decays(name: str, leaf: torch.Tensor) -> bool:
    if any(k in name for k in NO_DECAY):
        return False
    return leaf.dim() - (1 if name.startswith("blocks/") else 0) > 1


def drop_draws(generator: torch.Generator, m: Dict, B: int):
    """One step's random draws, in the program's documented order (the
    class and cond-type drop, then every layer's drop path): (drop (2, B)
    bool, keep (D, 2, B) fp32 factors mask / keep-rate)."""
    u = torch.rand(2, B, generator=generator)
    drop = u < m["cond_drop_rate"]
    D = m["depth"]
    rates = torch.linspace(0.0, m["drop_path_rate"], D, dtype=torch.float64).float()
    keep_rate = 1.0 - rates
    mask = (torch.rand(D, 2, B, generator=generator) < keep_rate[:, None, None]).float()
    return drop, mask / keep_rate[:, None, None]


def adamw_(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: Dict,
           step: int, lr: float, wd: float, betas, eps: float = 1e-8) -> None:
    """torch's AdamW (decoupled decay, bias correction) in place, written out."""
    b1, b2 = betas
    for name, p in params.items():
        g = grads[name]
        m, v = state.setdefault(name, (torch.zeros_like(p), torch.zeros_like(p)))
        if decays(name, p):
            p.mul_(1 - lr * wd)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v / (1 - b2 ** step)).sqrt_().add_(eps)
        p.addcdiv_(m, denom, value=-lr / (1 - b1 ** step))
