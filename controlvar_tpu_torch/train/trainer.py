"""Training orchestration: loader -> train step -> checkpoints.

The port of `controlvar_tpu/train/trainer.py` (the single-host replacement
for the reference's mp.spawn + DDP process loop, reference:
train_control_var_hpu.py:536-689). One process drives one device; a
multi-process run calls `parallel.distributed.initialize()` first and lays
the processes out as data x model_axis (`parallel.mesh.make_mesh`). Each
rank's loader reads the shard of its data index (`parallel.mesh.
data_shard`), and the steps average the gradients over the data group.
With model_axis above 1 the model is tensor parallel: each rank trains its
shard of the params (`parallel.tensor.shard_params`), its AdamW moments
live on that shard (`opt_state_shardings`, `shard_opt_state`: a whole
optimizer state from a checkpoint is cut to the shard), the ranks of a
model group draw the same drop-path and cond-drop masks, and checkpoints
hold the whole state (`ckpt/orbax_io.py`). Only the primary rank logs and
writes checkpoints. LoRA fine-tuning over a tensor-parallel base (the JAX
Trainer cuts the base and replicates the factors) makes the factors from
the whole base before it is cut, so every rank holds the same whole
factors and their moments, and its checkpoints hold them as they are.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from controlvar_tpu_torch.ckpt.orbax_io import CheckpointIO
from controlvar_tpu_torch.config import ControlVARConfig, OptimConfig, VQVAEConfig
from controlvar_tpu_torch.device import DeviceLike, generator_for, resolve_device, tree_to
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.parallel.distributed import barrier, form_global_batch, is_primary
from controlvar_tpu_torch.parallel.mesh import make_mesh
from controlvar_tpu_torch.parallel.tensor import (opt_state_shardings,  # noqa: F401
                                                  shard_opt_state, shard_params)
from controlvar_tpu_torch.train.train_step import (ControlVARTrainStep, TrainState,
                                                   init_train_state)


def _print_metrics(m: Dict) -> None:
    print(" ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                   for k, v in m.items()), flush=True)


@dataclasses.dataclass
class Trainer:
    """Runs on `cuda` unless device="cpu" is passed. `loader` is a
    `data.build.Loader` or, with from_tokens, a `data.shards.TokenShardLoader`;
    `vq_params` is the frozen VQVAE's tree (moved to the device in `fit`)."""

    model_cfg: ControlVARConfig
    vq_cfg: VQVAEConfig
    optim: OptimConfig
    loader: object
    vq_params: Dict
    ckpt_dir: Optional[str] = None
    model_axis: int = 1
    lora_rank: int = 0   # >0: LoRA fine-tune, only the (A, B) factors train
                         # (reference: train_control_var_hpu.py:449-470)
    from_tokens: bool = False  # the loader yields pre-tokenized batches: the
                               # step skips both frozen VQVAE encoder passes
    log_every: int = 50
    save_every_steps: Optional[int] = None
    stop_after: Optional[int] = None  # checkpoint-and-exit after N steps
                                      # WITHOUT touching the lr horizon
                                      # (preemption simulation / timeboxing)
    profile_dir: Optional[str] = None  # torch.profiler trace of steps 10-13
    log_fn: Callable[[Dict], None] = _print_metrics
    device: DeviceLike = None

    def __post_init__(self):
        if self.from_tokens and self.model_cfg.bidirectional:
            # pretokenize stores only the mask-first ignore order
            # (data/shards.write_token_shard); the image-first coin flip
            # would mis-weight the loss: use the pixel path for that recipe
            raise ValueError(
                "from_tokens does not support bidirectional training: token "
                "shards carry only the mask-first ignore_mask order"
            )
        self.device = resolve_device(self.device)
        self.mesh = make_mesh(model=self.model_axis, cfg=self.model_cfg)
        self.model = ControlVARModel(self.model_cfg, device=self.device, mesh=self.mesh)
        self.vqvae = VQVAE(self.vq_cfg, device=self.device)
        self.steps_per_epoch = self.loader.steps_per_epoch()
        self.set_max_steps(self.optim.epochs * self.steps_per_epoch)
        # a LoRA state (the factors) is whole on every rank, a full one is
        # the rank's shard
        self.io = (CheckpointIO(self.ckpt_dir, mesh=None if self.lora_rank else self.mesh,
                                cfg=self.model_cfg) if self.ckpt_dir else None)

    def set_max_steps(self, max_steps: int):
        """Cap the training horizon (e.g. `--steps` smoke runs). Must be
        called BEFORE init_state: it rebuilds the stepper so the lr/wd
        schedule anneals over the capped horizon, not epochs*spe."""
        self.max_steps = max_steps
        warmup = max(1, int(self.optim.warmup_init_frac * max_steps))
        self.stepper = ControlVARTrainStep(self.model, self.vqvae, self.optim, max_steps,
                                           warmup, device=self.device)

    # ---- state -------------------------------------------------------------

    def init_state(self, seed: int = 0, base_params: Optional[Dict] = None) -> TrainState:
        """base_params: pretrained weights (e.g. converted .pth after VAR
        surgery), whole. With lora_rank > 0 they become the frozen LoRA base
        and the TrainState holds only the (A, B) factors, made from the whole
        tree; with model_axis > 1 the base, or the TrainState, is this rank's
        shard."""
        params = base_params or self.model.init_params(seed)
        params = tree_to(params, self.device)
        whole = params
        if self.model.tp is not None:
            params = shard_params(self.mesh, params, self.mesh.model_index, self.model_cfg)
        self._lora_stepper = None
        if self.lora_rank > 0:
            from controlvar_tpu_torch.ckpt.lora import LoRAConfig
            from controlvar_tpu_torch.train.train_step import LoRAControlVARTrainStep

            self._lora_stepper = LoRAControlVARTrainStep(
                self.stepper, LoRAConfig(rank=self.lora_rank))
            self._base_params = params
            return self._lora_stepper.init_lora_state(generator_for(seed + 1), whole,
                                                      self.optim)
        return init_train_state(params, self.optim)

    def maybe_resume(self, state: TrainState):
        """(state, start epoch): the latest checkpoint loaded into `state`
        in place, or `state` and 0 when there is none."""
        if self.io is None:
            return state, 0
        restored, meta = self.io.restore(state)
        if restored is None:
            return state, 0
        return restored, (meta or {}).get("epoch", 0)

    def _save(self, step: int, state: TrainState, epoch: int) -> None:
        """The primary rank writes (under tensor parallelism every rank
        takes part in the gather of a sharded state); every rank waits until
        the file is whole, so that any of them may restore it."""
        if is_primary() or self.io.tp is not None:
            self.io.save(step, state, metadata={"epoch": epoch})
        barrier()

    def _generator(self, step_i: int) -> torch.Generator:
        """The step's generator (drop path, cond drop), seeded from (step,
        data index) so that data shards draw apart and the ranks of a model
        group draw alike; generator_for(step_i) at one rank."""
        return generator_for(step_i * self.mesh.data + self.mesh.data_index)

    # ---- loop --------------------------------------------------------------

    def fit_with_recovery(self, state: TrainState, start_epoch: int = 0,
                          max_restarts: int = 3) -> TrainState:
        """Crash-restart wrapper: on a transient device/runtime failure,
        restore the latest checkpoint and continue (the reference only has
        this commented out, train_control_var_hpu.py:702-708)."""
        restarts = 0
        while True:
            try:
                return self.fit(state, start_epoch)
            except (RuntimeError, OSError) as e:
                restarts += 1
                if self.io is None or restarts > max_restarts:
                    raise
                print(f"[recovery] {type(e).__name__}: {e}; restart "
                      f"{restarts}/{max_restarts} from latest checkpoint",
                      flush=True)
                restored, meta = self.io.restore(state)
                if restored is not None:
                    state = restored
                    start_epoch = (meta or {}).get("epoch", start_epoch)

    def fit(self, state: TrainState, start_epoch: int = 0,
            mask_first_sampler: Optional[Callable[[int], bool]] = None) -> TrainState:
        vq_params = tree_to(self.vq_params, self.device)
        profiler = None
        if self.profile_dir:
            from controlvar_tpu_torch.utils.tracker import StepProfiler

            profiler = StepProfiler(self.profile_dir)
        rng = np.random.default_rng(1234)
        step_i = int(state.step)
        spe = self.loader.steps_per_epoch()
        for epoch in range(start_epoch, self.optim.epochs):
            t_last = time.time()
            # mid-epoch resume: a restored step count inside this epoch
            # skips the already-consumed prefix (deterministic per-epoch
            # shuffle) instead of re-training it
            skip = min(spe, max(0, step_i - epoch * spe))
            stop = (min(self.max_steps, self.stop_after)
                    if self.stop_after else self.max_steps)
            for batch in self.loader.epoch(epoch, skip_batches=skip):
                if step_i >= stop:
                    break
                # bidirectional: coin flip per step (reference :193-202)
                mask_first = True
                if self.model_cfg.bidirectional and (
                    mask_first_sampler(step_i) if mask_first_sampler
                    else rng.random() < 0.5
                ):
                    mask_first = False
                if self.from_tokens:
                    # pre-tokenized batch: per-scale id lists instead of
                    # pixels; ignore_mask is optional and always mask-first
                    # order (enforced in __post_init__)
                    keys = ("ctrl_ids", "img_ids", "cls", "type", "ignore_mask")
                else:
                    # the step weights by ignore_mask or ignore_mask_ by order
                    keys = ("image", "mask", "cls", "type", "ignore_mask", "ignore_mask_")
                dev_batch = form_global_batch(self.device,
                                              {k: batch[k] for k in keys if k in batch})
                if profiler is not None:
                    profiler.step(step_i)
                gen = self._generator(step_i)
                if self._lora_stepper is not None:
                    state, metrics = self._lora_stepper.step(
                        state, self._base_params, vq_params, dev_batch, gen, mask_first,
                        from_tokens=self.from_tokens)
                else:
                    state, metrics = self.stepper.step(
                        state, vq_params, dev_batch, gen, mask_first,
                        from_tokens=self.from_tokens, accum=self.optim.grad_accum)
                if step_i % self.log_every == 0 and is_primary():
                    # metrics are the global batch's; only the primary logs
                    # (reference: rank-0 wandb, train_control_var_hpu.py:257)
                    m = {k: float(v) for k, v in metrics.items()}
                    m.update(step=step_i, epoch=epoch,
                             sec_per_step=(time.time() - t_last) / self.log_every)
                    t_last = time.time()
                    self.log_fn(m)
                if (
                    self.io is not None
                    and self.save_every_steps
                    and step_i > 0
                    and step_i % self.save_every_steps == 0
                ):
                    self._save(step_i, state, epoch)
                step_i += 1
            if self.io is not None:
                # a max_steps cap can stop MID-epoch: record the current
                # epoch then, so resume skips only the consumed prefix
                # instead of starting the next epoch
                ep_meta = epoch + 1 if step_i >= (epoch + 1) * spe else epoch
                self._save(int(state.step), state, ep_meta)
            if step_i >= stop:
                break
        if self.io is not None:
            self.io.wait()
        return state
