"""The comparisons that decide `correct`: what the timed path produced,
against the plain reference (`cvbench/reference/`), which regenerates the
weights from the seed and works out every token pyramid, teacher-forcing
input and canvas again itself.

Conditional generation (checked images of greedy and of sampled calls):
  tok_gap     the program's tokenizer ids of the control image: the widest
              squared distance of a chosen code above the nearest one's, in
              units of the median nearest distance (exact encoder features);
  logit_gap   every served token, greedy: the widest gap by which its
              CFG-combined logit lies below the reference's best, in nats
              (the reference's full teacher-forced forward of the four CFG
              branches over the served token streams);
  logit_mean  the same gaps' mean over every served greedy token;
  decode_rms  greedy: the program's image against the reference's decode of
              the served image ids, root mean square over the pixels in
              [0, 1];
  draw_outside sampled: the share of served tokens that lie outside the
              reference's top-k / top-p kept set of the fp32 CFG-combined
              logits (`reference/sampling.py`).
Training (the first three steps, through the window's own call): the
program's tokenizer ids of both images of every step, judged as tok_gap
above along their own chain; then the reference trains on those ids (the
residual chain turns a bf16 near-tie at a coarse scale into other ids at
every finer one, which would hide the steps' arithmetic), and
  loss_rel    the widest relative gap of a step's loss;
  grad_gap    the first step's clipped gradient as the optimizer holds it
              (AdamW's first moment over 1 - beta1), each leaf's norm against
              the reference's, the widest gap over max(that leaf's norm, the
              median leaf's);
  change_gap  the same of each leaf's change after three steps, over the
              leaves whose reference gradient is at least a thousandth of the
              median leaf's (the others move by round-off alone).

`control` computes the same numbers with the reference in the program's
place at fp8 (`reference.prec`): its own greedy choices, or its own draws
from its kept set, at each served position, its own tokenizer ids, its
own decode.
"""
from __future__ import annotations

import statistics
from typing import Dict, Sequence

import torch

from cvbench import weights as W
from cvbench.reference import controlvar as cv
from cvbench.reference import sampling as rs
from cvbench.reference import train as rt
from cvbench.reference import vqvae as vq
from cvbench.reference.prec import Prec, exact

# ---- conditional generation ---------------------------------------------------


def _streams(rec: Dict, b: int, m: Dict):
    """One checked image's token streams: the forced group's (control =
    the program's tokenizer ids, image = the drawn ones) and the uncond
    group's (both drawn), per scale (1, pn^2)."""
    forced_c, forced_i, unc_c, unc_i = [], [], [], []
    for si, p in enumerate(m["patch_nums"]):
        l = p * p
        out = rec["draws"][si][b: b + 1]              # [forced image | uncond ctrl, image]
        forced_c.append(rec["forced"][si][b: b + 1])
        forced_i.append(out[:, :l])
        unc_c.append(out[:, l: 2 * l])
        unc_i.append(out[:, 2 * l:])
    return (forced_c, forced_i), (unc_c, unc_i)


def _branch_logits(P, VQ, m, v, label, ctype, forced, unc, prec: Prec) -> torch.Tensor:
    """(4, L, V) logits of the CFG branches [full | class dropped | class and
    type dropped | uncond stream]."""
    null = torch.full_like(label, m["num_classes"])
    uncond = torch.full_like(ctype, cv.COND_UNCOND)
    x_f = cv.interleave(vq.teacher_inputs(VQ, forced[0], v), vq.teacher_inputs(VQ, forced[1], v))
    x_u = cv.interleave(vq.teacher_inputs(VQ, unc[0], v), vq.teacher_inputs(VQ, unc[1], v))
    labels = torch.cat([label, null, null, null])
    ctypes = torch.cat([ctype, ctype, uncond, uncond])
    x_tf = torch.cat([x_f, x_f, x_f, x_u])
    return cv.forward(P, m, labels, ctypes, x_tf, prec)


def _combined(logits: torch.Tensor, m: Dict, cfg_scales, si: int) -> torch.Tensor:
    lo, hi = cv.scale_bounds(m)[si]
    w = cv.cfg_weights(cfg_scales, si, len(m["patch_nums"]))
    return sum(wr * logits[r, lo:hi] for r, wr in enumerate(w))


def _served(forced, unc, si: int, l: int):
    """(rows of the combined logits, served ids) of scale si: the forced
    group's image half, the uncond group's control and image halves."""
    return [(slice(l, 2 * l), forced[1][si][0]), (slice(0, l), unc[0][si][0]),
            (slice(l, 2 * l), unc[1][si][0])]


def _served_gaps(logits32, logits_pick, forced, unc, m, cfg_scales):
    """The gaps below the best of fp32 combined logits at the served
    positions, of the served tokens (logits_pick None) or of the tokens
    that logits_pick puts first: (the widest, their sum, their count)."""
    worst, total, n = 0.0, 0.0, 0
    for si, p in enumerate(m["patch_nums"]):
        l = p * p
        c32 = _combined(logits32, m, cfg_scales, si)
        best = c32.max(dim=-1).values
        if logits_pick is None:
            picks = _served(forced, unc, si, l)
        else:
            top = _combined(logits_pick, m, cfg_scales, si).argmax(dim=-1)
            picks = [(slice(0, 2 * l), top)]
        for rows, ids in picks:
            gap = best[rows] - c32[rows].gather(1, ids.reshape(-1, 1).long())[:, 0]
            worst = max(worst, float(gap.max()))
            total += float(gap.sum())
            n += gap.numel()
    return worst, total, n


def _outside(logits32, logits_pick, forced, unc, m, traffic, generator) -> Dict:
    """The served tokens of a sampled image (logits_pick None), or the
    tokens that logits_pick's kept set gives at the same positions, against
    the fp32 combined logits' kept set: how many lie outside it (their
    mass above, `rs.mass_above`, is top_p or more), and how many there
    are."""
    k, top_p = traffic["top_k"], traffic["top_p"]
    out, n = 0, 0
    for si, p in enumerate(m["patch_nums"]):
        l = p * p
        c32 = _combined(logits32, m, traffic["cfg"], si)
        if logits_pick is None:
            picks = _served(forced, unc, si, l)
        else:
            c8 = _combined(logits_pick, m, traffic["cfg"], si)
            picks = [(slice(0, 2 * l), rs.draw(c8, k, top_p, generator))]
        for rows, ids in picks:
            out += int((rs.mass_above(c32[rows], ids, k) >= top_p).sum())
            n += ids.numel()
    return dict(out=out, n=n)


def judge_cond(cfg: Dict, traffic: Dict, seed: int, checked: Sequence, device,
               control: bool = False) -> Dict[str, float]:
    """The numbers over the checked images. checked: (rec, b) pairs, rec a
    recorded call (greedy or not, labels, types, control images, forced
    ids, draws per scale; a greedy call's images on the host), b the
    image's row in it. Greedy images give logit_gap, logit_mean and
    decode_rms, sampled ones draw_outside, all of them tok_gap. A cell's
    limits name the numbers it compares."""
    m, v = cfg["model"], cfg["vqvae"]
    P = W.controlvar_params(m, cfg["init"], seed, device)
    VQ = W.vqvae_params(v, seed, device)
    low = Prec("fp8")
    gen = torch.Generator(device=device).manual_seed(W.sub_seed(seed, "control draw"))
    tok, sq, n = 0.0, 0.0, 0
    worst, total, count = 0.0, 0.0, 0
    drawn = dict(out=0, n=0)
    with torch.no_grad(), exact():
        for rec, b in checked:
            forced, unc = _streams(rec, b, m)
            img = rec["control"][b: b + 1]
            f32 = vq.encode(VQ, img, v, Prec())
            if control:
                ids8 = vq.nearest_ids(VQ, vq.encode(VQ, img, v, low), v, forced[0])
                tok = max(tok, vq.code_gaps(VQ, f32, ids8, v, chain=forced[0]))
            else:
                tok = max(tok, vq.code_gaps(VQ, f32, forced[0], v))
            label, ctype = rec["labels"][b: b + 1], rec["types"][b: b + 1]
            l32 = _branch_logits(P, VQ, m, v, label, ctype, forced, unc, Prec())
            l8 = _branch_logits(P, VQ, m, v, label, ctype, forced, unc, low) if control else None
            if not rec["greedy"]:
                d = _outside(l32, l8, forced, unc, m, traffic, gen)
                drawn = {k: drawn[k] + d[k] for k in drawn}
                continue
            w, t, c = _served_gaps(l32, l8, forced, unc, m, traffic["cfg"])
            worst, total, count = max(worst, w), total + t, count + c
            del l32, l8
            f_hat = vq.fhat_from_ids(VQ, forced[1], v)
            want = (vq.decode(VQ, f_hat, v, Prec()) + 1) * 0.5
            if control:
                got = (vq.decode(VQ, f_hat, v, low) + 1) * 0.5
            else:
                got = rec["images"][b: b + 1].to(device)
            sq += float(((got.float() - want) ** 2).sum())
            n += want.numel()
    return {"tok_gap": tok, "logit_gap": worst, "logit_mean": total / max(count, 1),
            "decode_rms": (sq / max(n, 1)) ** 0.5,
            "draw_outside": drawn["out"] / max(drawn["n"], 1)}


# ---- training -----------------------------------------------------------------


def leaf_gap(got: Dict[str, float], want: Dict[str, float], keep=None) -> float:
    """The widest |got - want| of per-leaf norms over max(want's leaf norm,
    want's median leaf norm), over the leaves in `keep` (all by default)."""
    names = [k for k in want if keep is None or k in keep]
    med = statistics.median(want[k] for k in want)
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in names)


def reference_train(cfg: Dict, seed: int, batches: Sequence[Dict], generator,
                    device, prec: Prec, ids=None) -> Dict:
    """The reference's steps from the seed's weights, on the token ids `ids`
    (per step, (control, image)) or on its own at `prec`: losses, the first
    step's clipped gradient norms and each leaf's change norm, by leaf, and
    the ids trained on."""
    m, v, optim = cfg["model"], cfg["vqvae"], cfg["optim"]
    P = W.controlvar_params(m, cfg["init"], seed, device)
    VQ = W.vqvae_params(v, seed, device)
    p0 = {k: t.clone() for k, t in rt.leaves(P)}
    grad_norms: Dict[str, float] = {}

    def on_step(step, grads):
        if step == 1:
            grad_norms.update({k: float(g.double().norm()) for k, g in grads.items()})

    with exact():
        out = rt.train_steps(P, VQ, m, v, optim, batches, generator, prec, ids, on_step)
    change = {k: float((t.detach() - p0[k]).double().norm()) for k, t in rt.leaves(P)}
    return dict(out, grad=grad_norms, change=change)


def train_tok_gap(cfg: Dict, seed: int, batches: Sequence[Dict], ids, device) -> float:
    """`tok_gap` of the token ids a step trained on, both images of every
    checked step, each along its own chain against exact features."""
    v = cfg["vqvae"]
    VQ = W.vqvae_params(v, seed, device)
    worst = 0.0
    with torch.no_grad(), exact():
        for batch, pair in zip(batches, ids):
            for img, chain in zip((batch["mask"], batch["image"]), pair):
                f = vq.encode(VQ, img[: chain[0].shape[0]], v, Prec())
                worst = max(worst, vq.code_gaps(VQ, f, chain, v))
    return worst


def judge_train(got: Dict, want: Dict) -> Dict[str, float]:
    """The training numbers of the readings `got` against the reference's
    `want` on the same token ids (both as `reference_train` returns them)."""
    med = statistics.median(want["grad"].values())
    moving = {k for k, g in want["grad"].items() if g >= 1e-3 * med}
    return {
        "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])),
        "grad_gap": leaf_gap(got["grad"], want["grad"]),
        "change_gap": leaf_gap(got["change"], want["change"], moving),
    }


def check_train(cfg: Dict, seed: int, batches: Sequence[Dict], generator_fn, device,
                got: Dict) -> Dict[str, float]:
    """A candidate's training numbers: its token ids judged by `tok_gap`, then
    its losses, gradient and change against the fp32 reference's steps on
    those ids. got: the candidate's readings with the ids it trained on."""
    ids = _complete(cfg, seed, batches, got["ids"], device)
    want = reference_train(cfg, seed, batches, generator_fn(), device, Prec(), ids)
    return dict(tok_gap=train_tok_gap(cfg, seed, batches, got["ids"], device),
                **judge_train(got, want))


def _complete(cfg: Dict, seed: int, batches: Sequence[Dict], ids, device):
    """The candidate's ids, with the reference's own for rows of a batch that
    the candidate did not tokenize (a step that left rows out)."""
    v = cfg["vqvae"]
    VQ = W.vqvae_params(v, seed, device)
    out = []
    with torch.no_grad(), exact():
        for batch, pair in zip(batches, ids):
            full = []
            for img, chain in zip((batch["mask"], batch["image"]), pair):
                n = chain[0].shape[0]
                if n < img.shape[0]:
                    own = rt.tokenize(VQ, v, img[n:], Prec())
                    chain = [torch.cat([a, b.to(a)]) for a, b in zip(chain, own)]
                full.append(chain)
            out.append(tuple(full))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """{name: {value, limit}} in the limits' order; a number is within its
    limit when it is at most the limit."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def all_within(checks: Dict[str, Dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
