"""Closed-loop class-conditional generation with plain VAR: one caller,
back-to-back `SamplingHarness.class_conditional` calls, each waited for
until its images are on the host.

Each call takes one of the traffic's `input_sets` sets of `batch` class
labels (uniform over the classes, made on the card from the seed and
cycled) and a new generator seed. Every `greedy_every`-th call draws
greedily (top-k 1) through the same path; the others sample with the
traffic's top-k and top-p, under the guidance `cfg` ramped over the scales.
Every call's served tokens are recorded where the sampler draws them:
`judge_var.judge_var` holds a sample of the greedy calls' images against
the reference's best tokens and decode, and a sample of the sampled
calls' against the reference's kept set.
"""
from __future__ import annotations

from typing import Dict

import torch

from cvbench import judge_var
from cvbench import weights as W
from cvbench import weights_var as WV
from cvbench.drivers.cond_sample import Driver as CondDriver


class Driver(CondDriver):
    """`cond_sample.Driver`'s window, profiled calls, release and checked
    images, over class-conditional calls."""

    kind = "sample"

    # ---- set-up ----------------------------------------------------------------

    def setup(self) -> None:
        """The model and tokenizer with the seed's weights, the label sets,
        and one sampled and one greedy call, which build and warm every
        kernel and shape of the window."""
        from controlvar_tpu_torch.config import SampleConfig
        from controlvar_tpu_torch.eval.harness import SamplingHarness
        from controlvar_tpu_torch.models.var import VARModel
        from controlvar_tpu_torch.models.vqvae import VQVAE

        if not hasattr(SamplingHarness, "class_conditional"):
            raise RuntimeError("the program serves no plain VAR model "
                               "(SamplingHarness.class_conditional)")
        t, cfg, dev = self.traffic, self.cfg, self.device
        mc, vc = WV.model_configs(cfg)
        model, vqvae = VARModel(mc, device=dev), VQVAE(vc, device=dev)
        common = dict(device=dev, compute_dtype=getattr(torch, cfg["compute_dtype"]))
        guidance = (t["cfg"],) * 3
        self.sampled = SamplingHarness(model, vqvae, SampleConfig(
            cfg=guidance, top_k=t["top_k"], top_p=t["top_p"]), **common)
        self.greedy = SamplingHarness(model, vqvae, SampleConfig(
            cfg=guidance, top_k=1, top_p=0.0), **common)
        self._record(self.sampled)
        self._record(self.greedy)
        params = WV.var_params(cfg["model"], cfg["init"], self.seed, dev)
        self.params = self.sampled.prepare_params(params)
        del params
        self.vq_params = W.vqvae_params(cfg["vqvae"], self.seed, dev)
        m = cfg["model"]
        self.inputs = [WV.labels(t["batch"], m["num_classes"], self.seed, f"inputs{k}", dev)
                       for k in range(t["input_sets"])]
        self.calls = 0
        self.call(greedy=False)
        self.call(greedy=True)
        self.records.clear()
        self.calls = 0

    def _record(self, harness) -> None:
        """Keep every draw's ids."""
        sampler = harness._var
        draw = sampler._draw

        def recorded_draw(logits, generator):
            ids = draw(logits, generator)
            self.records[-1]["draws"].append(ids)
            return ids

        sampler._draw = recorded_draw

    def call(self, greedy=None) -> int:
        """One call, waited for until its images are on the host; returns the
        images it made."""
        i = self.calls
        self.calls += 1
        every = self.traffic["greedy_every"]
        if greedy is None:
            greedy = i % every == every - 1
        labels = self.inputs[i % len(self.inputs)]
        gen = torch.Generator().manual_seed(W.sub_seed(self.seed, f"call{i}"))
        harness = self.greedy if greedy else self.sampled
        self.records.append(dict(greedy=greedy, labels=labels, draws=[]))
        img = harness.class_conditional(self.params, self.vq_params, labels, gen)
        host = img.cpu()
        if greedy:      # the decode is judged on the greedy calls' images
            self.records[-1]["images"] = host
        return labels.shape[0]

    def check(self, control: bool = False) -> Dict[str, float]:
        return judge_var.judge_var(self.cfg, self.traffic, self.seed, self.checked(),
                                   self.device, control)
