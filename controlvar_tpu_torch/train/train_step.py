"""The ControlVAR training step.

One optimizer step: frozen-VQVAE tokenization of the control and the image
(two bf16 encoder passes, no gradient), teacher-forcing features, the
scale-interleaved teacher-forced forward (attention through kernels K3/K4 on
the GPU), masked cross-entropy, the global gradient norm, clipping as optax
clips, and AdamW with the lr/wd of the step. Unlike the JAX package's pure
step, this one updates the parameters and the optimizer state in place.

Batch dict contract (tensors on the step's device):
  image  (B, 256, 256, 3) in [-1, 1]
  mask   (B, 256, 256, 3) in [-1, 1]   # the rendered condition image
  cls    (B,) int
  type   (B,) int                       # cond type id, multi_cond only
  ignore_mask (B, L) float optional     # loss weighting
Pre-tokenized batches (`from_tokens=True`) carry `ctrl_ids` and `img_ids`,
lists of per-scale (B, pn^2) ids, in place of `image` and `mask`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from controlvar_tpu_torch.config import OptimConfig
from controlvar_tpu_torch.device import DeviceLike, resolve_device, tree_to
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.train.lr_schedule import lr_wd_at_step
from controlvar_tpu_torch.train.param_groups import decay_groups, named_leaves

Params = Dict


@dataclasses.dataclass
class TrainState:
    """Parameters (leaf tensors that require grad), their AdamW optimizer and
    the number of steps taken. The step updates all three in place."""

    params: Params
    optimizer: torch.optim.AdamW
    step: int = 0


def make_optimizer(optim: OptimConfig, params: Params) -> torch.optim.AdamW:
    """AdamW over two groups, decayed and not (`train/param_groups.py`); the
    step writes each step's lr and wd into the groups. With eps 1e-8 and bias
    correction, torch's decoupled decay equals optax's scale_by_adam, then
    add_decayed_weights, then the lr scale."""
    decay, no_decay = decay_groups(params)
    return torch.optim.AdamW(
        [{"params": decay, "weight_decay": optim.weight_decay},
         {"params": no_decay, "weight_decay": 0.0}],
        lr=optim.lr, betas=(optim.beta1, optim.beta2), eps=1e-8)


def init_train_state(params: Params, optim: OptimConfig) -> TrainState:
    """A state at step 0 over `params`, whose leaves are set to require grad."""
    for _, leaf in named_leaves(params):
        leaf.requires_grad_(True)
    return TrainState(params, make_optimizer(optim, params))


def interleave_tokens(ctrl_ids, img_ids, ctrl_h, img_h, mask_first: bool = True):
    """Per-scale interleave of the (control, image) streams.

    ctrl_ids/img_ids: lists of (B, pn^2) ids for all S scales; ctrl_h/img_h:
    lists of (B, pn'^2, Cvae) teacher-forcing features, S-1 long. Returns
    (labels (B, L), x_tf (B, L - first_l, Cvae)), scale by scale [a_k | b_k]
    with a the control when mask_first."""
    a_ids, b_ids = (ctrl_ids, img_ids) if mask_first else (img_ids, ctrl_ids)
    a_h, b_h = (ctrl_h, img_h) if mask_first else (img_h, ctrl_h)
    labels = torch.cat([t for pair in zip(a_ids, b_ids) for t in pair], dim=1)
    x_tf = torch.cat([t for pair in zip(a_h, b_h) for t in pair], dim=1)
    return labels, x_tf


def _aligned_ignore(cfg, ign: Optional[torch.Tensor],
                    target_len: int) -> Optional[torch.Tensor]:
    """The dataset's ignore mask in the label layout: without separators it
    must already be (B, L)."""
    if ign is None:
        return None
    if cfg.separator:
        raise NotImplementedError("separator training is not ported yet")
    if ign.shape[1] != target_len:
        raise ValueError(f"ignore_mask has {ign.shape[1]} columns, the labels {target_len}")
    return ign


def _masked_ce(logits: torch.Tensor, labels: torch.Tensor, ignore: Optional[torch.Tensor],
               denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy in fp32, weighted by the ignore mask when given.

    `denom` overrides the weight-sum denominator: accumulation passes the
    whole batch's weight sum divided by accum, so that the mean of the
    microbatch losses is the whole batch's weighted mean."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[..., None].long())[..., 0]
    if ignore is None:
        return nll.mean()
    w = ignore.float()
    if denom is None:
        denom = w.sum() + 1e-6 * w.numel()
    return (nll * w).sum() / denom


def _microbatch(batch: Dict, i: int, size: int) -> Dict:
    """Rows [i*size, (i+1)*size) of every tensor of a batch (lists too)."""
    def cut(v):
        return [cut(t) for t in v] if isinstance(v, list) else v[i * size:(i + 1) * size]

    return {k: cut(v) for k, v in batch.items()}


class ControlVARTrainStep:
    """The ControlVAR train step. Runs on `cuda` unless device="cpu" is
    passed; the batch is moved to that device. The residual stream runs in
    `compute_dtype` and the frozen tokenizer in `tokenize_dtype`."""

    tokenize_dtype = torch.bfloat16
    compute_dtype = torch.bfloat16

    def __init__(self, model: ControlVARModel, vqvae: VQVAE, optim: OptimConfig,
                 max_steps: int, warmup_steps: int, device: DeviceLike = None):
        self.model, self.vqvae, self.optim = model, vqvae, optim
        self.max_steps, self.warmup_steps = max_steps, warmup_steps
        self.device = resolve_device(device)

    def _loss_from_ids(self, params, vq_params, ctrl_ids: List[torch.Tensor],
                       img_ids: List[torch.Tensor], batch, generator, mask_first,
                       loss_denom) -> Tuple[torch.Tensor, Dict]:
        with torch.no_grad():
            ctrl_h = self.vqvae.ids_to_var_input(vq_params, ctrl_ids)
            img_h = self.vqvae.ids_to_var_input(vq_params, img_ids)
        labels, x_tf = interleave_tokens(ctrl_ids, img_ids, ctrl_h, img_h, mask_first)
        logits = self.model.forward_train(
            params, batch["cls"], x_tf, cond_type=batch.get("type"),
            mask_first=mask_first, generator=generator, train=True,
            compute_dtype=self.compute_dtype)
        ign = _aligned_ignore(self.model.cfg, batch.get("ignore_mask"), labels.shape[1])
        loss = _masked_ce(logits, labels, ign, loss_denom)
        acc = (logits.argmax(dim=-1) == labels).float().mean()
        return loss, {"loss": loss.detach(), "acc": acc}

    def loss_fn(self, params, vq_params, batch, generator=None, mask_first=True,
                loss_denom=None):
        """(loss, {"loss", "acc"}) of a pixel batch: both images are
        tokenized by the frozen VQVAE, without gradient."""
        with torch.no_grad():
            ctrl_ids = self.vqvae.img_to_ids(vq_params, batch["mask"],
                                             compute_dtype=self.tokenize_dtype)
            img_ids = self.vqvae.img_to_ids(vq_params, batch["image"],
                                            compute_dtype=self.tokenize_dtype)
        return self._loss_from_ids(params, vq_params, ctrl_ids, img_ids, batch,
                                   generator, mask_first, loss_denom)

    def loss_fn_tokens(self, params, vq_params, batch, generator=None, mask_first=True,
                       loss_denom=None):
        """(loss, {"loss", "acc"}) of a pre-tokenized batch (`ctrl_ids`,
        `img_ids`): no encoder passes."""
        return self._loss_from_ids(params, vq_params, batch["ctrl_ids"], batch["img_ids"],
                                   batch, generator, mask_first, loss_denom)

    def step(self, state: TrainState, vq_params, batch, generator=None,
             mask_first: bool = True, from_tokens: bool = False,
             accum: int = 1) -> Tuple[TrainState, Dict]:
        """One optimizer step, in place on `state`; returns (state, aux) with
        aux = {loss, acc, lr, wd, grad_norm}, grad_norm the global norm
        before clipping.

        accum > 1 splits the batch into `accum` microbatches whose gradients
        are summed: each microbatch loss is normalized by the whole batch's
        ignore-mask weight divided by accum, so the update equals the single
        big-batch step's."""
        optim = self.optim
        lr, wd = lr_wd_at_step(optim.schedule, state.step, optim.lr, optim.weight_decay,
                               optim.wd_end, self.warmup_steps, self.max_steps,
                               wp0=optim.warmup_init_frac)
        loss_fn = self.loss_fn_tokens if from_tokens else self.loss_fn
        batch = tree_to(batch, self.device)
        state.optimizer.zero_grad(set_to_none=True)
        if accum <= 1:
            loss, aux = loss_fn(state.params, vq_params, batch, generator, mask_first)
            loss.backward()
        else:
            n = batch["cls"].shape[0]
            if n % accum:
                raise ValueError(f"batch of {n} does not split into {accum} microbatches")
            ign = _aligned_ignore(self.model.cfg, batch.get("ignore_mask"),
                                  self.model.cfg.seq_len)
            denom = None if ign is None else (ign.float().sum() + 1e-6 * ign.numel()) / accum
            aux = {"loss": 0.0, "acc": 0.0}
            for i in range(accum):
                loss_i, aux_i = loss_fn(state.params, vq_params,
                                        _microbatch(batch, i, n // accum), generator,
                                        mask_first, loss_denom=denom)
                (loss_i / accum).backward()
                aux = {k: aux[k] + aux_i[k] / accum for k in aux}
        grads = [leaf.grad for _, leaf in named_leaves(state.params) if leaf.grad is not None]
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        # optax's clip_by_global_norm: g * max_norm / norm when norm >= max_norm
        factor = torch.where(grad_norm < optim.grad_clip, 1.0, optim.grad_clip / grad_norm)
        for g in grads:
            g.mul_(factor)
        decay_group, no_decay_group = state.optimizer.param_groups
        decay_group["lr"] = no_decay_group["lr"] = lr
        decay_group["weight_decay"] = wd
        state.optimizer.step()
        state.step += 1
        return state, dict(aux, lr=lr, wd=wd, grad_norm=grad_norm)
