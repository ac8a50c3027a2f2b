"""Faults planted in the program underneath a run, each of which `correct`
has to catch (`cvbench/tests/test_cvbench_faults.py` at the tiny size,
`cvbench/calibrate.py --fault-seeds` at a cell's own size):

  sampling cells  drop_top_p      K2's wrapper draws over the top k alone;
                  altered_token   a token altered where the sampler draws it;
  training cells  state_unchanged a step that returns its state unchanged;
                  half_batch      half of the batch left out, the mean taken
                                  over the rest.
On one chip there is no exchange between chips to leave out.

Each fault is a context manager that patches the program while it is open.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name: str, value):
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def drop_top_p():
    from controlvar_tpu_torch.ops import sampling

    bisect = sampling.sample_top_k_top_p_bisect

    def top_k_only(logits, top_k=0, top_p=0.0, generator=None, noise=None):
        return bisect(logits, top_k, 0.0, generator=generator, noise=noise)

    return _patched(sampling, "sample_top_k_top_p_bisect", top_k_only)


def altered_token():
    from controlvar_tpu_torch.eval import stepwise

    draw = stepwise._SamplerBase._draw

    def altered(self, logits, generator):
        ids = draw(self, logits, generator).clone()
        ids[..., -1] = (ids[..., -1] + 1) % logits.shape[-1]
        return ids

    return _patched(stepwise._SamplerBase, "_draw", altered)


def state_unchanged():
    import torch

    from controlvar_tpu_torch.train import train_step

    def no_update(state, grad_clip, lr, wd, group=None, tp=None, cfg=None):
        state.step += 1
        return torch.zeros(())

    return _patched(train_step, "_clip_and_update", no_update)


def half_batch():
    from controlvar_tpu_torch.train.train_step import ControlVARTrainStep

    loss_fn = ControlVARTrainStep.loss_fn

    def half(self, params, vq_params, batch, *args, **kwargs):
        n = batch["cls"].shape[0] // 2
        return loss_fn(self, params, vq_params, {k: v[:n] for k, v in batch.items()}, *args,
                       **kwargs)

    return _patched(ControlVARTrainStep, "loss_fn", half)


FAULTS = {"sample": {"drop_top_p": drop_top_p, "altered_token": altered_token},
          "train": {"state_unchanged": state_unchanged, "half_batch": half_batch}}
