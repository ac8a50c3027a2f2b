"""Back-to-back `ControlVARTrainStep.step` calls at the configuration's
recipe: B pixel batches of image and control, classes and cond types
uniform, from a pool of `pool` distinct batches made on the card from the
seed and cycled. The step's own generator (cond drop, drop path) is seeded
from the seed.

Set-up builds one train state and drives it through the first
`checked_steps` steps on distinct batches, through the same call the window
makes; the program's readings of them (the token ids its tokenizer gave,
the losses, the first step's gradient from AdamW's first moment, each
leaf's change) are taken then, and the reference follows the same steps
after the window (`judge.check_train`).
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from cvbench import devtrace, judge
from cvbench import weights as W


class Driver:
    kind = "train"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)

    def _batches(self):
        t, cfg, dev = self.traffic, self.cfg, self.device
        B, size = t["batch"], cfg["vqvae"]["image_size"]
        out = []
        for k in range(t["pool"]):
            cls, typ = W.labels_types(B, cfg["model"]["num_classes"], 4, self.seed,
                                      f"batch{k}", dev)
            out.append({"image": W.pixel_images(B, size, self.seed, f"image{k}", dev),
                        "mask": W.pixel_images(B, size, self.seed, f"mask{k}", dev),
                        "cls": cls, "type": typ})
        return out

    def _generator(self) -> torch.Generator:
        return torch.Generator().manual_seed(W.sub_seed(self.seed, "step"))

    def setup(self) -> None:
        from controlvar_tpu_torch.config import OptimConfig
        from controlvar_tpu_torch.models.control_var import ControlVARModel
        from controlvar_tpu_torch.models.vqvae import VQVAE
        from controlvar_tpu_torch.train.train_step import ControlVARTrainStep, init_train_state

        cfg, dev, o = self.cfg, self.device, self.cfg["optim"]
        mc, vc = W.model_configs(cfg)
        model, vqvae = ControlVARModel(mc, device=dev), VQVAE(vc, device=dev)
        optim = OptimConfig(base_lr=o["base_lr"], total_batch_size=o["total_batch_size"],
                            weight_decay=o["weight_decay"], weight_decay_end=o["weight_decay"],
                            beta1=o["beta1"], beta2=o["beta2"], grad_clip=o["grad_clip"],
                            schedule=o["schedule"])
        self.stepper = ControlVARTrainStep(model, vqvae, optim, max_steps=o["max_steps"],
                                           warmup_steps=0, device=dev,
                                           remat=self.traffic["remat"])
        dtype = getattr(torch, cfg["compute_dtype"])
        self.stepper.compute_dtype = self.stepper.tokenize_dtype = dtype
        params = W.controlvar_params(cfg["model"], cfg["init"], self.seed, dev)
        p0 = {k: t.clone() for k, t in W.named_leaves(params)}
        self.state = init_train_state(params, optim)
        self.vq_params = W.vqvae_params(cfg["vqvae"], self.seed, dev)
        self.batches = self._batches()
        self.gen = self._generator()
        self.steps = 0
        # the checked steps' tokenizer ids (control, then image, a step), read
        # where the step's frozen tokenizer returns them
        vqvae, tokenized = self.stepper.vqvae, []
        tokenize = vqvae.img_to_ids

        def recorded(*args, **kwargs):
            tokenized.append(tokenize(*args, **kwargs))
            return tokenized[-1]

        vqvae.img_to_ids = recorded
        losses, grad = [], {}
        for _ in range(self.traffic["checked_steps"]):
            aux = self.step()
            losses.append(float(aux["loss"]))
            if not grad:
                grad = self._first_gradient()
        del vqvae.img_to_ids
        change = {k: float((t.detach() - p0[k]).double().norm())
                  for k, t in W.named_leaves(self.state.params)}
        del p0
        ids = list(zip(tokenized[0::2], tokenized[1::2]))
        self.readings = dict(losses=losses, grad=grad, change=change, ids=ids)

    def _first_gradient(self) -> Dict[str, float]:
        """Each leaf's clipped gradient norm, from AdamW's state after one
        step: exp_avg = (1 - beta1) g."""
        beta1 = self.cfg["optim"]["beta1"]
        state = self.state.optimizer.state
        # a leaf the optimizer never stepped holds no moment: it reads 0
        return {k: float((state[t]["exp_avg"] / (1 - beta1)).double().norm())
                if "exp_avg" in state.get(t, {}) else 0.0
                for k, t in W.named_leaves(self.state.params)}

    def step(self) -> Dict:
        batch = self.batches[self.steps % len(self.batches)]
        self.steps += 1
        _, aux = self.stepper.step(self.state, self.vq_params, batch, self.gen)
        return aux

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _steps(self, n: int) -> int:
        for _ in range(n):
            self.step()
            self._sync()
        return n

    def window(self, seconds: float) -> Dict:
        """Steps dispatched back to back for `seconds`, with no synchronize
        between them, so that the device works through a stall of the host
        on what is queued (the program's step itself waits for the device
        where it copies its host-drawn drop masks over, so at most about a
        step is queued). When the time is up nothing more is sent,
        every step sent is waited for, and the clock is read after that wait.
        `gaps`: the host's seconds between the returns of successive steps."""
        self._sync()
        start = time.perf_counter()
        ends = [start]
        while ends[-1] - start < seconds:
            self.step()
            ends.append(time.perf_counter())
        self._sync()
        gaps = [b - a for a, b in zip(ends, ends[1:])]
        return dict(seconds=time.perf_counter() - start, units=len(gaps), gaps=gaps)

    def traced(self, steps: int) -> Dict:
        """`steps` steps under the profiler."""
        from controlvar_tpu_torch.ops.attention import flash_attention, flash_attention_bwd

        self._sync()
        flash_attention.launches = flash_attention_bwd.launches = 0
        tr = devtrace.profile(torch, lambda: self._steps(steps))
        launches = {"K3": flash_attention.launches, "K4": flash_attention_bwd.launches}
        return dict(trace=tr, launches=launches)

    def release(self) -> None:
        del self.state, self.stepper, self.vq_params
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: bool = False) -> Dict[str, float]:
        """The numbers of the program's checked steps, or with control those
        of the reference in fp8 in the program's place (its own ids)."""
        from cvbench.reference.prec import Prec

        batches = self.batches[: self.traffic["checked_steps"]]
        got = self.readings
        if control:
            got = judge.reference_train(self.cfg, self.seed, batches, self._generator(),
                                        self.device, Prec("fp8"))
        return judge.check_train(self.cfg, self.seed, batches, self._generator, self.device,
                                 got)
