"""Reference training steps of ControlVAR over a frozen VQVAE: both images
of a sample tokenized (exactly, or the ids of the step it follows), the
teacher-forced forward, the mean
cross-entropy over every position, the gradient clipped by its global norm
as optax clips it, and AdamW. The rows of a batch go through the forward
and backward one at a time (their gradients summed), so that the fp32
activations of the full-width model fit beside its optimizer state.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from cvbench.reference import controlvar as cv
from cvbench.reference import vqvae as vq
from cvbench.reference.prec import Prec


def leaves(tree, prefix: str = ""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            yield from leaves(v, name)
        else:
            yield name, v


def tokenize(VQ: Dict, v: Dict, img: torch.Tensor, prec: Prec) -> List[torch.Tensor]:
    """Per-scale ids (N, pn^2) of images, each scale's nearest code along the
    chain of the reference's own choices."""
    return vq.nearest_ids(VQ, vq.encode(VQ, img, v, prec), v)


def lr_wd(optim: Dict):
    """The recipe's lr and wd at the steps taken here: after a warm-up of
    none, lin0 holds the peak lr for the first 5% of the run, and wd_end =
    wd holds the weight decay."""
    return optim["base_lr"] * optim["total_batch_size"] / 512, optim["weight_decay"]


def train_steps(P: Dict, VQ: Dict, m: Dict, v: Dict, optim: Dict,
                batches: Sequence[Dict], generator: torch.Generator, prec: Prec,
                ids: Optional[Sequence] = None, on_step=None) -> Dict:
    """Steps over `batches` in place on P (fp32 leaves). ids: optional
    (control ids, image ids) of each step's images to train on, each
    per-scale (B, pn^2); without them the reference tokenizes the images
    itself at `prec`. on_step(step, grads): called with each step's clipped
    gradients, by leaf name, before the update. Returns the losses and the
    ids trained on."""
    named = dict(leaves(P))
    for p in named.values():
        p.requires_grad_(True)
    state: Dict = {}
    lr, wd = lr_wd(optim)
    losses, used = [], []
    for step, batch in enumerate(batches, start=1):
        B = batch["cls"].shape[0]
        drop, keep = cv.drop_draws(generator, m, B)
        drop, keep = drop.to(batch["cls"].device), keep.to(batch["cls"].device)
        labels = torch.where(drop[0], m["num_classes"], batch["cls"])
        ctype = torch.where(drop[1], cv.COND_UNCOND, batch["type"])
        with torch.no_grad():
            if ids is None:
                ids_c, ids_i = (tokenize(VQ, v, batch["mask"], prec),
                                tokenize(VQ, v, batch["image"], prec))
            else:
                ids_c, ids_i = ids[step - 1]
            used.append((ids_c, ids_i))
            x_tf = cv.interleave(vq.teacher_inputs(VQ, ids_c, v), vq.teacher_inputs(VQ, ids_i, v))
            target = cv.interleave(ids_c, ids_i)
        loss = 0.0
        for r in range(B):
            logits = cv.forward(P, m, labels[r: r + 1], ctype[r: r + 1], x_tf[r: r + 1], prec,
                                keep[:, :, r: r + 1])
            row = F.cross_entropy(logits[0], target[r]) / B
            row.backward()
            loss += float(row.detach())
        grads = {k: p.grad for k, p in named.items()}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        if float(norm) >= optim["grad_clip"]:
            for g in grads.values():
                g.mul_(optim["grad_clip"] / norm.float())
        if on_step is not None:
            on_step(step, grads)
        with torch.no_grad():
            cv.adamw_(named, grads, state, step, lr, wd, (optim["beta1"], optim["beta2"]))
        for p in named.values():
            p.grad = None
        losses.append(loss)
    for p in named.values():
        p.requires_grad_(False)
    return {"losses": losses, "ids": used}
