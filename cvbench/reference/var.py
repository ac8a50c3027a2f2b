"""Plain VAR (FoundationVision/VAR models/var.py over basic_var.py): the
teacher-forced forward of class-conditional VAR over one token stream
[sos | scale 1 | ... | scale S-1] under the block-causal mask, with
`attn_l2_norm` (cosine attention, a learnt per-head `scale_mul`) and shared
AdaLN (`--saln=1`: one `shared_ada_lin` = Linear(C, 6C) of SiLU(cond) for
the model, to which each block adds its own `ada_gss` (6, C) before the
split into gamma1, gamma2, scale1, scale2, shift1, shift2), then the AdaLN
head (`AdaLNBeforeHead`) and the vocabulary projection.

`m` is a configuration's "model" dict; `P` the tree of
`cvbench/weights_var.py` (dense kernels stored (in, out), block leaves
stacked over the depth). The layers run one after the other in fp32 (TF32
off, `prec.exact`) or at fp8 (`Prec("fp8")`), so that a row of the
full-width model fits.

Departures from the published model: inference only (no dropout, no drop
path, no class drop); the shared modulation is made again in each layer,
with that layer's ada_gss as a bias (`per_layer_ada`: the same sums); the CFG branches are whole forwards, combined after
the head (`cfg_weights`), where the published sampler combines its logits
the same way; the teacher-forcing inputs come from `reference/vqvae.py:
teacher_inputs` (VAR's `idxBl_to_var_input`).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from cvbench.reference import controlvar as cv
from cvbench.reference.prec import Prec


def level_index(m: Dict) -> torch.Tensor:
    return torch.cat([torch.full((p * p,), i) for i, p in enumerate(m["patch_nums"])])


def scale_bounds(m: Dict):
    """[lo, hi) of each scale's pn^2 positions."""
    out, cur = [], 0
    for p in m["patch_nums"]:
        out.append((cur, cur + p * p))
        cur += p * p
    return out


def cfg_weights(cfg: float, si: int, num_scales: int) -> List[float]:
    """The two CFG branches' weights at scale si (the guidance ramps
    linearly over the scales): (1 + t) cond - t uncond."""
    t = cfg * si / (num_scales - 1)
    return [1.0 + t, -t]


def per_layer_ada(P: Dict, m: Dict) -> Dict:
    """The blocks with shared AdaLN written as each layer's own ada_lin, as
    `reference/controlvar.py:_block` takes it: the shared kernel for every
    layer (a view), and the shared bias plus the layer's ada_gss, laid out
    as the (6, C) split of the 6C outputs, as its bias. The same sums:
    SiLU(cond) W + b + ada_gss."""
    b, s = P["blocks"], P["shared_ada_lin"]
    D, C = m["depth"], m["embed_dim"]
    ada = {"kernel": s["kernel"].expand(D, *s["kernel"].shape),
           "bias": s["bias"] + b["ada_gss"].reshape(D, 6 * C)}
    return dict(P, blocks=dict(b, ada_lin=ada))


def forward(P: Dict, m: Dict, labels: torch.Tensor, x_tf: torch.Tensor, prec: Prec
            ) -> torch.Tensor:
    """Logits (N, L, V) of the teacher-forced sequence. labels (N,) class
    ids (num_classes: the unconditional class); x_tf (N, L - first_l, z):
    the teacher-forcing features of scales 1 .. S-1. Each layer is
    `reference/controlvar.py:_block` (basic_var.py's AdaLNSelfAttn, which
    ControlVAR keeps) under `per_layer_ada`."""
    device = x_tf.device
    C = m["embed_dim"]
    cond = P["class_emb"][labels]
    sos = cond[:, None, :] + P["pos_start"]
    x = torch.cat([sos, prec.linear(x_tf, P["word_embed"]["kernel"], P["word_embed"]["bias"])],
                  dim=1)
    lvl = level_index(m).to(device)
    x = x + P["lvl_embed"][lvl][None] + P["pos_1LC"]
    mask = lvl[:, None] >= lvl[None, :]
    layers = per_layer_ada(P, m)
    for li in range(m["depth"]):
        x = cv._block(layers, li, x, cond, m, prec, mask)
    ada = prec.linear(F.silu(cond), P["head_nm"]["ada_lin"]["kernel"],
                      P["head_nm"]["ada_lin"]["bias"])
    scale, shift = ada.reshape(-1, 1, 2, C).unbind(2)
    h = cv._layer_norm(x, m["norm_eps"]) * (scale + 1) + shift
    return prec.linear(h, P["head"]["kernel"], P["head"]["bias"])


def combined(logits: torch.Tensor, m: Dict, cfg: float, si: int) -> torch.Tensor:
    """Scale si's CFG-combined logits (pn^2, V) of one image's two branches'
    logits (2, L, V) [cond | uncond]."""
    lo, hi = scale_bounds(m)[si]
    w = cfg_weights(cfg, si, len(m["patch_nums"]))
    return w[0] * logits[0, lo:hi] + w[1] * logits[1, lo:hi]


def branch_inputs(label: torch.Tensor, x_tf: torch.Tensor, num_classes: int):
    """The two CFG branches of one image: labels [label | uncond] and the
    same teacher-forcing features twice."""
    return torch.cat([label, torch.full_like(label, num_classes)]), x_tf.repeat(2, 1, 1)


def teacher_features(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Scales 1 .. S-1's teacher-forcing features (`vqvae.teacher_inputs`)
    as one (N, L - first_l, z) sequence."""
    return torch.cat(list(parts), dim=1)
