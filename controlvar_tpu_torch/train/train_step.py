"""The training steps: ControlVAR, its LoRA fine-tune, and plain VAR.

One optimizer step: frozen-VQVAE tokenization of the control and the image
(two bf16 encoder passes, no gradient), teacher-forcing features, the
scale-interleaved teacher-forced forward (attention through kernels K3/K4 on
the GPU, each layer recomputed in the backward under the step's remat
policy), masked cross-entropy, the global gradient norm, clipping as optax
clips, and AdamW with the lr/wd of the step. Unlike the JAX package's pure
steps, these update the parameters and the optimizer state in place.
`LoRAControlVARTrainStep` trains only LoRA factors over a frozen base;
`VARTrainStep` tokenizes one image a sample for the class-conditional VAR.
Inside a `torch.distributed` process group every step averages its
gradients over the ranks before the clip (`parallel.distributed`), and the
ControlVAR and LoRA steps normalize the loss by the global batch's
ignore-mask weight. A tensor-parallel ControlVAR model (its mesh's model
axis above 1) trains this rank's shard: the ranks of a model group see the
same rows, so the gradients are averaged and the loss weight summed over
the data group alone, and the clip's global norm sums the cut leaves'
squares over the model group and counts each whole leaf once. The LoRA
step over a tensor-parallel base keeps its factors whole on every rank: it
sums the gradients of the factors of cut kernels over the model group, then
averages every factor's gradient over the data group, so the factors stay
bit-equal across the world. The VAR step takes no model axis (`VARModel`
refuses one, as no JAX entry point trains VAR on a mesh).

Batch dict contract (numpy arrays or tensors; the step copies them to its
device with `data.build.to_device`):
  image  (B, 256, 256, 3) in [-1, 1]
  mask   (B, 256, 256, 3) in [-1, 1]   # the rendered condition image
  cls    (B,) int
  type   (B,) int                       # cond type id, multi_cond only
  ignore_mask (B, L) float optional     # loss weighting, mask-first order
  ignore_mask_ (B, L) float optional    # the same, image-first order
A step with mask_first=False (bidirectional training) weights its loss by
`ignore_mask_`. With a separator, a mask without separator columns gets
weight-1 columns spliced in at the separator slots.
Pre-tokenized batches (`from_tokens=True`) carry `ctrl_ids` and `img_ids`,
lists of per-scale (B, pn^2) ids, in place of `image` and `mask`.

Inside a torch.profiler window a step opens its spans (`utils/tracker.py:
span`): cv/step holding cv/tokenize (the encoder passes), cv/forward,
cv/backward and cv/update (its all-reduce of the gradients in
cv/allreduce), and cv/wait where the host blocks on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch

from controlvar_tpu_torch.ckpt.lora import LoRAConfig, apply_lora, init_lora_params
from controlvar_tpu_torch.config import OptimConfig
from controlvar_tpu_torch.data.build import to_device
from controlvar_tpu_torch.device import DeviceLike, resolve_device
from controlvar_tpu_torch.models.control_var import ControlVARModel, separator_mapping
from controlvar_tpu_torch.models.var import VARModel
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.parallel.distributed import (all_reduce_sum, average_gradients,
                                                       group_size)
from controlvar_tpu_torch.parallel.tensor import (leaf_split, lora_cut_keys, square_sum,
                                                  sum_of_squares, sum_over_model_)
from controlvar_tpu_torch.train.lr_schedule import lr_wd_at_step
from controlvar_tpu_torch.train.param_groups import decay_groups, named_leaves
from controlvar_tpu_torch.utils.tracker import span

Params = Dict


@dataclasses.dataclass
class TrainState:
    """Parameters (leaf tensors that require grad), their AdamW optimizer and
    the number of steps taken. The step updates all three in place."""

    params: Params
    optimizer: torch.optim.AdamW
    step: int = 0


def make_optimizer(optim: OptimConfig, params: Params) -> torch.optim.AdamW:
    """AdamW over two groups, decayed (first) and not (`train/
    param_groups.py`); the step writes each step's lr and wd into the
    groups. With eps 1e-8 and bias correction, torch's decoupled decay
    equals optax's scale_by_adam, then add_decayed_weights, then the lr
    scale."""
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


def interleave_tokens(ctrl_ids, img_ids, ctrl_h, img_h, mask_first: bool = True,
                      separator: bool = False, vocab_size: int = 0):
    """Per-scale interleave of the (control, image) streams.

    ctrl_ids/img_ids: lists of (B, pn^2) ids for all S scales; ctrl_h/img_h:
    lists of (B, pn'^2, Cvae) teacher-forcing features, S-1 long. Returns
    (labels (B, L), x_tf (B, L_words - first_l, Cvae)), scale by scale
    [a_k | b_k] with a the control when mask_first. With separator, every
    segment after scale 0 is followed in the labels by its separator's
    target, mapping index + vocab_size (`separator_mapping`); x_tf never
    holds separator slots (forward_train splices the learned embeddings)."""
    a_ids, b_ids = (ctrl_ids, img_ids) if mask_first else (img_ids, ctrl_ids)
    a_h, b_h = (ctrl_h, img_h) if mask_first else (img_h, ctrl_h)
    parts = [t for pair in zip(a_ids, b_ids) for t in pair]
    if separator:
        mapping = separator_mapping(mask_first)
        spliced = parts[:2]
        for i, part in enumerate(parts[2:]):
            spliced += [part, torch.full_like(part[:, :1], mapping[i] + vocab_size)]
        parts = spliced
    labels = torch.cat(parts, dim=1)
    x_tf = torch.cat([t for pair in zip(a_h, b_h) for t in pair], dim=1)
    return labels, x_tf


def splice_separator_ones(ign: torch.Tensor, patch_nums) -> torch.Tensor:
    """A separator-free ignore mask (B, 2 sum(pn^2)) in the separator
    layout: a weight-1 column after every segment after scale 0, where
    `interleave_tokens` puts the separator targets."""
    one = torch.ones_like(ign[:, :1])
    out, off = [], 0
    for si, pn in enumerate(patch_nums):
        for _ in range(2):
            out.append(ign[:, off: off + pn * pn])
            off += pn * pn
            if si:
                out.append(one)
    return torch.cat(out, dim=1)


def _aligned_ignore(cfg, ign: Optional[torch.Tensor],
                    target_len: int) -> Optional[torch.Tensor]:
    """The dataset's ignore mask in the label layout: with a separator, a
    separator-free mask gets `splice_separator_ones`; then it must be
    (B, target_len)."""
    if ign is None:
        return None
    if cfg.separator and ign.shape[1] != target_len:
        ign = splice_separator_ones(ign, cfg.patch_nums)
    if ign.shape[1] != target_len:
        raise ValueError(f"ignore_mask has {ign.shape[1]} columns, the labels {target_len}")
    return ign


def _order_ignore(batch: Dict, mask_first: bool) -> Optional[torch.Tensor]:
    """The batch's ignore mask for the stream order: `ignore_mask` when
    mask_first, else `ignore_mask_` (the JAX trainer's choice). A batch that
    carries only the mask-first one (a token shard) cannot weight an
    image-first step, and raises, as the JAX trainer refuses such a run."""
    if mask_first:
        return batch.get("ignore_mask")
    if "ignore_mask" in batch and "ignore_mask_" not in batch:
        raise ValueError("an image-first (mask_first=False) step needs the batch's "
                         "ignore_mask_; this batch carries only the mask-first ignore_mask")
    return batch.get("ignore_mask_")


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


def _data_group(model):
    """The group a step averages over: the data group of a model's mesh,
    the whole world (None) without one."""
    mesh = getattr(model, "mesh", None)
    return None if mesh is None else mesh.data_group


def _clip_and_update(state: TrainState, grad_clip: float, lr: float, wd: float,
                     group=None, tp=None, cfg=None):
    """Average the gradients of state's params over the ranks of `group`
    (`parallel.distributed.average_gradients`; None: the whole world;
    nothing without a process group), clip them by their global norm as
    optax clips, then take the optimizer step at (lr, wd), wd on the first
    (the decayed) group only. Returns the norm before clipping: of the
    whole model when tp is the mesh of a tensor-parallel model of config
    cfg whose shard state.params is (the cut leaves' squares summed over
    the model group)."""
    with span("update"):
        named = [(name, leaf) for name, leaf in named_leaves(state.params)]
        average_gradients([leaf for _, leaf in named], group=group)
        grads = [leaf.grad for _, leaf in named if leaf.grad is not None]
        if tp is None:
            grad_norm = torch.sqrt(square_sum(grads)).float()
        else:
            split = [leaf_split(name, cfg, tp.model) is not None
                     for name, leaf in named if leaf.grad is not None]
            grad_norm = torch.sqrt(sum_of_squares(grads, split, tp))
        # optax's clip_by_global_norm: g * max_norm / norm when norm >= max_norm
        factor = torch.where(grad_norm < grad_clip, 1.0, grad_clip / grad_norm)
        for g in grads:
            g.mul_(factor)
        groups = state.optimizer.param_groups
        for group in groups:
            group["lr"] = lr
        groups[0]["weight_decay"] = wd
        state.optimizer.step()
        state.step += 1
        return grad_norm


class _TrainStep:
    """What the steps share: the model, the frozen tokenizer, the optimizer
    recipe and schedule, the device, the dtypes and the remat policy."""

    tokenize_dtype = torch.bfloat16
    compute_dtype = torch.bfloat16

    def __init__(self, model: Union[ControlVARModel, VARModel], vqvae: VQVAE,
                 optim: OptimConfig, max_steps: int, warmup_steps: int,
                 device: DeviceLike = None, remat: str = "full"):
        self.model, self.vqvae, self.optim = model, vqvae, optim
        self.max_steps, self.warmup_steps = max_steps, warmup_steps
        self.device = resolve_device(device)
        self.remat = remat

    def _lr_wd(self, step: int) -> Tuple[float, float]:
        optim = self.optim
        return lr_wd_at_step(optim.schedule, step, optim.lr, optim.weight_decay, optim.wd_end,
                             self.warmup_steps, self.max_steps, wp0=optim.warmup_init_frac)


class ControlVARTrainStep(_TrainStep):
    """The ControlVAR train step. Runs on `cuda` unless device="cpu" is
    passed; the batch is moved to that device. The residual stream runs in
    `compute_dtype`, the frozen tokenizer in `tokenize_dtype`, and the
    layers are recomputed under `remat` (full | dots | dots_attn)."""

    def _loss_from_ids(self, params, vq_params, ctrl_ids: List[torch.Tensor],
                       img_ids: List[torch.Tensor], batch, generator, mask_first,
                       loss_denom) -> Tuple[torch.Tensor, Dict]:
        with span("forward"):
            with torch.no_grad():
                ctrl_h = self.vqvae.ids_to_var_input(vq_params, ctrl_ids)
                img_h = self.vqvae.ids_to_var_input(vq_params, img_ids)
            cfg = self.model.cfg
            labels, x_tf = interleave_tokens(ctrl_ids, img_ids, ctrl_h, img_h, mask_first,
                                             separator=cfg.separator,
                                             vocab_size=cfg.vocab_size)
            logits = self.model.forward_train(
                params, batch["cls"], x_tf, cond_type=batch.get("type"),
                mask_first=mask_first, generator=generator, train=True,
                compute_dtype=self.compute_dtype, remat=self.remat)
            ign = _aligned_ignore(cfg, _order_ignore(batch, mask_first), labels.shape[1])
            loss = _masked_ce(logits, labels, ign, loss_denom)
            acc = (logits.argmax(dim=-1) == labels).float().mean()
            return loss, {"loss": loss.detach(), "acc": acc}

    def loss_fn(self, params, vq_params, batch, generator=None, mask_first=True,
                loss_denom=None):
        """(loss, {"loss", "acc"}) of a pixel batch: both images are
        tokenized by the frozen VQVAE, without gradient."""
        with torch.no_grad(), span("tokenize"):
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

    def _backward(self, params, vq_params, batch, generator=None, mask_first: bool = True,
                 from_tokens: bool = False, accum: int = 1) -> Dict:
        """The gradient of the loss, accumulated into the `.grad` of params'
        leaves (which the caller zeroes); returns aux = {loss, acc}.

        accum > 1 splits the batch into `accum` microbatches whose gradients
        are summed: each microbatch loss is normalized by the whole batch's
        ignore-mask weight divided by accum, so the update equals the single
        big-batch step's. Inside a process group of W ranks, each holding
        its rows of the global batch, that weight is all-reduced over the
        ranks and divided by accum * W, so that the mean of the ranks'
        gradients (`average_gradients`, in the update) is the global batch's
        and not a mean of per-rank means; aux is averaged over the ranks.
        Under tensor parallelism the ranks are those of the data group: a
        model group's ranks hold the same rows."""
        loss_fn = self.loss_fn_tokens if from_tokens else self.loss_fn
        group = _data_group(self.model)
        world = group_size(group)
        if accum <= 1 and world == 1:
            loss, aux = loss_fn(params, vq_params, batch, generator, mask_first)
            with span("backward"):
                loss.backward()
            return aux
        n = batch["cls"].shape[0]
        if n % accum:
            raise ValueError(f"batch of {n} does not split into {accum} microbatches")
        ign = _aligned_ignore(self.model.cfg, _order_ignore(batch, mask_first),
                              self.model.cfg.seq_len)
        denom = None if ign is None else all_reduce_sum(
            ign.float().sum() + 1e-6 * ign.numel(), group) / (accum * world)
        aux = {"loss": 0.0, "acc": 0.0}
        for i in range(accum):
            loss_i, aux_i = loss_fn(params, vq_params, _microbatch(batch, i, n // accum),
                                    generator, mask_first, loss_denom=denom)
            with span("backward"):
                (loss_i / accum).backward()
            aux = {k: aux[k] + aux_i[k] / accum for k in aux}
        if world > 1:
            both = all_reduce_sum(torch.stack([aux["loss"], aux["acc"]]).detach(), group) / world
            aux = {"loss": both[0], "acc": both[1]}
        return aux

    def step(self, state: TrainState, vq_params, batch, generator=None,
             mask_first: bool = True, from_tokens: bool = False,
             accum: int = 1) -> Tuple[TrainState, Dict]:
        """One optimizer step, in place on `state`; returns (state, aux) with
        aux = {loss, acc, lr, wd, grad_norm}, grad_norm the global norm
        before clipping. `_backward` says how accum and a process group split
        the batch."""
        with span("step"):
            lr, wd = self._lr_wd(state.step)
            batch = to_device(batch, self.device)
            state.optimizer.zero_grad(set_to_none=True)
            aux = self._backward(state.params, vq_params, batch, generator, mask_first,
                                 from_tokens, accum)
            model = self.model
            grad_norm = _clip_and_update(state, self.optim.grad_clip, lr, wd,
                                         _data_group(model), model.tp, model.cfg)
            return state, dict(aux, lr=lr, wd=wd, grad_norm=grad_norm)


class LoRAControlVARTrainStep:
    """The LoRA fine-tuning step (the JAX package's `LoRAControlVARTrainStep`;
    reference peft path: train_control_var_hpu.py:449-470). Its TrainState
    holds the LoRA (A, B) tree alone; the base params are merged on the fly
    by `apply_lora`, detached, so only the factors get gradients, and the
    clip's global norm is theirs. The loss, dtypes, device and remat policy
    are those of `base`. Over a tensor-parallel model the base params are
    this rank's shard and the factors whole (module docstring)."""

    def __init__(self, base: ControlVARTrainStep, lora_cfg: LoRAConfig):
        self.base, self.lora_cfg = base, lora_cfg

    def init_lora_state(self, generator: torch.Generator, base_params: Params,
                        optim: OptimConfig) -> TrainState:
        """Fresh factors (`init_lora_params`) and their optimizer: the JAX
        chain clip, scale_by_adam, add_decayed_weights with no mask, lr, that
        is one AdamW group that decays every A and B (the clip is the
        step's). base_params is the whole tree (or a tree of its shapes),
        also under tensor parallelism: every rank then makes the factors that
        one process makes from the same generator."""
        lora = init_lora_params(generator, base_params, self.lora_cfg)
        leaves = [leaf.requires_grad_(True) for _, leaf in named_leaves(lora)]
        opt = torch.optim.AdamW([{"params": leaves, "weight_decay": optim.weight_decay}],
                                lr=optim.lr, betas=(optim.beta1, optim.beta2), eps=1e-8)
        return TrainState(lora, opt)

    def step(self, state: TrainState, base_params: Params, vq_params, batch,
             generator=None, mask_first: bool = True,
             from_tokens: bool = False) -> Tuple[TrainState, Dict]:
        """One optimizer step of the factors, in place on `state`; returns
        (state, aux) as `ControlVARTrainStep.step` does. base_params (this
        rank's shard under tensor parallelism) is left as it was and gets no
        gradient."""
        with span("step"):
            base = self.base
            model = base.model
            lr, wd = base._lr_wd(state.step)
            batch = to_device(batch, base.device)
            state.optimizer.zero_grad(set_to_none=True)
            params = apply_lora(base_params, state.params, self.lora_cfg, mesh=model.mesh,
                                model_cfg=model.cfg)
            aux = base._backward(params, vq_params, batch, generator, mask_first, from_tokens)
            if model.tp is not None:
                # a cut kernel's factors got the part of their gradient that
                # this rank's shard gives; a whole kernel's got all of it
                cut_keys = lora_cut_keys(state.params, model.cfg, model.tp.model)
                sum_over_model_([state.params[k][f].grad for k in cut_keys
                                 for f in ("A", "B")], model.tp)
            grad_norm = _clip_and_update(state, base.optim.grad_clip, lr, wd,
                                         _data_group(model))
            return state, dict(aux, lr=lr, wd=wd, grad_norm=grad_norm)


class VARTrainStep(_TrainStep):
    """The plain-VAR train step (reference: train_var_hpu.py:121-206). Runs
    on `cuda` unless device="cpu" is passed. Batch: `image` (B, 256, 256, 3)
    in [-1, 1], `cls` (B,), optional `ignore_mask` (B, L); the images are
    tokenized by the frozen VQVAE inside the step, without gradient."""

    def loss_fn(self, params, vq_params, batch, generator=None) -> Tuple[torch.Tensor, Dict]:
        with torch.no_grad(), span("tokenize"):
            ids = self.vqvae.img_to_ids(vq_params, batch["image"],
                                        compute_dtype=self.tokenize_dtype)
        with span("forward"):
            with torch.no_grad():
                h = self.vqvae.ids_to_var_input(vq_params, ids)
            labels, x_tf = torch.cat(ids, dim=1), torch.cat(h, dim=1)
            logits = self.model.forward_train(params, batch["cls"], x_tf, generator=generator,
                                              train=True, compute_dtype=self.compute_dtype,
                                              remat=self.remat)
            loss = _masked_ce(logits, labels, batch.get("ignore_mask"))
            acc = (logits.argmax(dim=-1) == labels).float().mean()
            return loss, {"loss": loss.detach(), "acc": acc}

    def step(self, state: TrainState, vq_params, batch,
             generator=None) -> Tuple[TrainState, Dict]:
        """One optimizer step, in place on `state`; returns (state, aux) with
        aux = {loss, acc, lr, wd, grad_norm}."""
        with span("step"):
            lr, wd = self._lr_wd(state.step)
            batch = to_device(batch, self.device)
            state.optimizer.zero_grad(set_to_none=True)
            loss, aux = self.loss_fn(state.params, vq_params, batch, generator)
            with span("backward"):
                loss.backward()
            grad_norm = _clip_and_update(state, self.optim.grad_clip, lr, wd)
            return state, dict(aux, lr=lr, wd=wd, grad_norm=grad_norm)
