"""The comparisons that decide `correct` in a plain VAR sampling cell: the
served tokens of the timed path against the plain reference
(`cvbench/reference/var.py`), which regenerates the weights from the seed
and runs the two CFG branches' full teacher-forced forward over each
checked image's served token stream.

  logit_gap    greedy images: the widest gap by which a served token's
               CFG-combined logit lies below the reference's best, in nats;
  logit_mean   the same gaps' mean over every served greedy token;
  decode_rms   greedy images: the program's image against the reference's
               decode of the served ids, root mean square over the pixels
               in [0, 1];
  draw_outside sampled images: the share of served tokens that lie outside
               the reference's top-k / top-p kept set of the fp32
               CFG-combined logits (`reference/sampling.py`).
No image is tokenized, so there is no tok_gap.

`control` computes the same numbers with the reference in the program's
place at fp8 (`reference.prec`): its own greedy choices, or its own draws
from its kept set, at each served position, and its own decode.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from cvbench import weights as W
from cvbench import weights_var as WV
from cvbench.reference import sampling as rs
from cvbench.reference import var as rv
from cvbench.reference import vqvae as vq
from cvbench.reference.prec import Prec, exact


def _logits(P, VQ, m, v, label, ids, prec: Prec) -> torch.Tensor:
    """(2, L, V) logits of one image's CFG branches [cond | uncond] over its
    served token stream `ids` (per scale (1, pn^2))."""
    x_tf = rv.teacher_features(vq.teacher_inputs(VQ, ids, v))
    labels, x = rv.branch_inputs(label, x_tf, m["num_classes"])
    return rv.forward(P, m, labels, x, prec)


def judge_var(cfg: Dict, traffic: Dict, seed: int, checked: Sequence, device,
              control: bool = False) -> Dict[str, float]:
    """The numbers over the checked images. checked: (rec, b) pairs, rec a
    recorded call (greedy or not, labels, the draws per scale; a greedy
    call's images on the host), b the image's row in it."""
    m, v = cfg["model"], cfg["vqvae"]
    P = WV.var_params(m, cfg["init"], seed, device)
    VQ = W.vqvae_params(v, seed, device)
    low = Prec("fp8")
    gen = torch.Generator(device=device).manual_seed(W.sub_seed(seed, "control draw"))
    k, top_p, guidance = traffic["top_k"], traffic["top_p"], traffic["cfg"]
    worst, total, count, out, drawn = 0.0, 0.0, 0, 0, 0
    sq, n = 0.0, 0
    with torch.no_grad(), exact():
        for rec, b in checked:
            ids = [d[b: b + 1].long() for d in rec["draws"]]
            label = rec["labels"][b: b + 1]
            l32 = _logits(P, VQ, m, v, label, ids, Prec())
            l8 = _logits(P, VQ, m, v, label, ids, low) if control else None
            for si in range(len(m["patch_nums"])):
                c32 = rv.combined(l32, m, guidance, si)
                c8 = None if l8 is None else rv.combined(l8, m, guidance, si)
                if rec["greedy"]:
                    picks = ids[si][0] if c8 is None else c8.argmax(dim=-1)
                    gap = c32.max(dim=-1).values - c32.gather(1, picks.reshape(-1, 1))[:, 0]
                    worst = max(worst, float(gap.max()))
                    total, count = total + float(gap.sum()), count + gap.numel()
                else:
                    picks = ids[si][0] if c8 is None else rs.draw(c8, k, top_p, gen)
                    out += int((rs.mass_above(c32, picks, k) >= top_p).sum())
                    drawn += picks.numel()
            del l32, l8
            if not rec["greedy"]:
                continue
            f_hat = vq.fhat_from_ids(VQ, ids, v)
            want = (vq.decode(VQ, f_hat, v, Prec()) + 1) * 0.5
            if control:
                got = (vq.decode(VQ, f_hat, v, low) + 1) * 0.5
            else:
                got = rec["images"][b: b + 1].to(device)
            sq += float(((got.float() - want) ** 2).sum())
            n += want.numel()
    return {"logit_gap": worst, "logit_mean": total / max(count, 1),
            "decode_rms": (sq / max(n, 1)) ** 0.5, "draw_outside": out / max(drawn, 1)}
