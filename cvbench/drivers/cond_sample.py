"""Closed-loop control-conditioned generation: one caller, back-to-back
`SamplingHarness.control_conditioned` calls, each waited for until its
image is on the host.

Each call takes one of the traffic's `input_sets` sets of `batch` labels,
cond types and control images (made on the card from the seed and cycled)
and a new generator seed. Every `greedy_every`-th call draws greedily (top-k
1) through the same path; the others sample with the traffic's top-k and
top-p. Every call's served tokens, read where the sampler draws them, and
its tokenizer ids are recorded: `judge.judge_cond` holds a sample of the
greedy calls' images against the reference's best tokens and decode, and a
sample of the sampled calls' against the reference's kept set.
"""
from __future__ import annotations

import random
import time
from typing import Dict, List

import torch

from cvbench import devtrace, judge
from cvbench import weights as W


class Driver:
    kind = "sample"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.records: List[Dict] = []

    # ---- set-up ----------------------------------------------------------------

    def setup(self) -> None:
        """The model and tokenizer with the seed's weights, the input sets, and
        one sampled and one greedy call, which build and warm every kernel
        and shape of the window."""
        from controlvar_tpu_torch.config import SampleConfig
        from controlvar_tpu_torch.eval.harness import SamplingHarness
        from controlvar_tpu_torch.models.control_var import ControlVARModel
        from controlvar_tpu_torch.models.vqvae import VQVAE

        t, cfg, dev = self.traffic, self.cfg, self.device
        mc, vc = W.model_configs(cfg)
        model, vqvae = ControlVARModel(mc, device=dev), VQVAE(vc, device=dev)
        common = dict(decode_generated_only=t["decode_generated_only"], device=dev,
                      compute_dtype=getattr(torch, cfg["compute_dtype"]))
        self.sampled = SamplingHarness(model, vqvae, SampleConfig(
            cfg=tuple(t["cfg"]), top_k=t["top_k"], top_p=t["top_p"]), **common)
        self.greedy = SamplingHarness(model, vqvae, SampleConfig(
            cfg=tuple(t["cfg"]), top_k=1, top_p=0.0), **common)
        self._record(self.sampled)
        self._record(self.greedy)
        params = W.controlvar_params(cfg["model"], cfg["init"], self.seed, dev)
        self.params = self.sampled.prepare_params(params)
        del params
        self.vq_params = W.vqvae_params(cfg["vqvae"], self.seed, dev)
        B, size = t["batch"], cfg["vqvae"]["image_size"]
        m = cfg["model"]
        self.inputs = []
        for k in range(t["input_sets"]):
            labels, types = W.labels_types(B, m["num_classes"], 4, self.seed, f"inputs{k}", dev)
            imgs = W.pixel_images(B, size, self.seed, f"control{k}", dev)
            self.inputs.append((labels, types, imgs))
        self.calls = 0
        self.call(greedy=False)
        self.call(greedy=True)
        self.records.clear()
        self.calls = 0

    def _record(self, harness) -> None:
        """Keep each call's tokenizer ids and every draw's ids."""
        sampler = harness._cond_mask
        draw, tokenize = sampler._draw, harness._tokenize

        def recorded_draw(logits, generator):
            ids = draw(logits, generator)
            self.records[-1]["draws"].append(ids)
            return ids

        def recorded_tokenize(vq_params, img):
            ids = tokenize(vq_params, img)
            self.records[-1]["forced"] = ids
            return ids

        sampler._draw, harness._tokenize = recorded_draw, recorded_tokenize

    def call(self, greedy=None) -> int:
        """One call, waited for until its image is on the host; returns the
        images it made."""
        i = self.calls
        self.calls += 1
        every = self.traffic["greedy_every"]
        if greedy is None:
            greedy = i % every == every - 1
        labels, types, imgs = self.inputs[i % len(self.inputs)]
        gen = torch.Generator().manual_seed(W.sub_seed(self.seed, f"call{i}"))
        harness = self.greedy if greedy else self.sampled
        self.records.append(dict(greedy=greedy, labels=labels, types=types, control=imgs,
                                 draws=[]))
        _, img = harness.control_conditioned(self.params, self.vq_params, labels, types, gen,
                                             imgs)
        host = img.cpu()
        if greedy:      # the decode is judged on the greedy calls' images
            self.records[-1]["images"] = host
        return labels.shape[0]

    # ---- the window ----------------------------------------------------------------

    def window(self, seconds: float) -> Dict:
        """Calls back to back for `seconds`; the last call begun ends the window."""
        lat, images = [], 0
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            t = time.perf_counter()
            images += self.call()
            lat.append(time.perf_counter() - t)
        return dict(seconds=time.perf_counter() - start, units=len(lat), images=images,
                    latencies=lat)

    def traced(self, calls: int) -> Dict:
        """`calls` calls under the profiler."""
        from controlvar_tpu_torch.ops.attention import decode_attention
        from controlvar_tpu_torch.ops.sample_kernel import sample_top_k_top_p_bisect

        decode_attention.launches = sample_top_k_top_p_bisect.launches = 0

        def run():
            for _ in range(calls):
                self.call()
            return calls

        tr = devtrace.profile(torch, run)
        launches = {"K1": decode_attention.launches, "K2": sample_top_k_top_p_bisect.launches}
        return dict(trace=tr, launches=launches)

    # ---- correctness -------------------------------------------------------------

    def release(self) -> None:
        del self.params, self.vq_params, self.sampled, self.greedy
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def checked(self):
        """The checked images: samples drawn from the seed of the finished
        greedy calls' images (`check_images`) and of the sampled calls'
        (`check_sampled`)."""
        rng = random.Random(W.sub_seed(self.seed, "check"))
        out = []
        for greedy, key in ((True, "check_images"), (False, "check_sampled")):
            pool = [(rec, b) for rec in self.records if rec["greedy"] == greedy
                    for b in range(rec["labels"].shape[0])]
            if not pool:
                raise RuntimeError(f"no {'greedy' if greedy else 'sampled'} call finished: "
                                   f"the window is shorter than "
                                   f"{self.traffic['greedy_every']} calls")
            out += rng.sample(pool, min(self.traffic[key], len(pool)))
        return out

    def check(self, control: bool = False) -> Dict[str, float]:
        return judge.judge_cond(self.cfg, self.traffic, self.seed, self.checked(), self.device,
                                control)
