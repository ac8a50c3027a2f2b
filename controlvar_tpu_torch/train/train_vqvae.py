"""VQVAE (tokenizer) training: the two-optimizer GAN loop.

The port of `controlvar_tpu/train/train_vqvae.py`, the reference's G/D
alternation (reference: train_vqvae.py:105-158):
  G step: L1 + LPIPS + adaptive weight * hinge G + codebook losses
  D step: hinge on real/fake patch logits (disc warm-up via disc_start)
Adam betas (0.5, 0.9), eps 1e-8, for both (reference: train_vqvae.py:
258-259). The adaptive weight takes the gradient norms of the nll and of
the GAN term at the decoder's output conv kernel (reference:
losses/vqperceptual.py:63-74). Both steps update the state in place and run
on the device of their VQVAE.

The G step takes three gradients, as the JAX package does: of the nll
alone and of the GAN term alone, at that kernel only, then of the total
loss over every parameter. The first two reuse the third's reconstruction
(one encoder/decoder forward), which a traced JAX step shares too.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from controlvar_tpu_torch.data.build import to_device
from controlvar_tpu_torch.device import generator_for, tree_to
from controlvar_tpu_torch.losses import discriminator as disc_mod
from controlvar_tpu_torch.losses import lpips as lpips_mod
from controlvar_tpu_torch.losses.lpips import lpips_distance
from controlvar_tpu_torch.losses.vqperceptual import VQLPIPSWithDiscriminator
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.train.param_groups import named_leaves

Params = Dict
LAST_LAYER = ("decoder", "conv_out", "kernel")


@dataclasses.dataclass
class GANTrainState:
    """Both param trees (leaves that require grad), their Adam optimizers,
    the number of G/D step pairs taken and the codebook-usage EMA state
    (reference: models/quant.py:75-101)."""

    vq_params: Params
    disc_params: Params
    vq_opt: torch.optim.Adam
    disc_opt: torch.optim.Adam
    step: int
    usage: Dict


@dataclasses.dataclass
class DualGANTrainState(GANTrainState):
    """GANTrainState with the mask codebook's usage state."""

    mask_usage: Dict


def _leaf(tree, path=LAST_LAYER) -> torch.Tensor:
    for k in path:
        tree = tree[k]
    return tree


def _backward_into(loss: torch.Tensor, params: Params) -> None:
    """loss's gradient into the `.grad` of params' leaves only (the
    discriminator's weights, which the G loss also reaches, get none)."""
    loss.backward(inputs=[leaf for _, leaf in named_leaves(params)])


def _trainable(tree: Params) -> list:
    return [leaf.requires_grad_(True) for _, leaf in named_leaves(tree)]


class _GANStep:
    """What both tokenizer steps share: the VQVAE (its device is theirs),
    the loss and Adam's lr."""

    def __init__(self, vqvae: VQVAE, loss: VQLPIPSWithDiscriminator, lr: float = 1e-4):
        self.vqvae, self.loss, self.lr = vqvae, loss, lr
        self.device = vqvae.device

    def make_optimizers(self, vq_params: Params, disc_params: Params
                        ) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
        """optax.adam(lr, b1=0.5, b2=0.9) over each tree; the leaves are set
        to require grad."""
        make = lambda tree: torch.optim.Adam(_trainable(tree), lr=self.lr, betas=(0.5, 0.9),
                                             eps=1e-8)
        return make(vq_params), make(disc_params)

    def _init_trees(self, seed: int, lpips_seed):
        """(vq_params, disc_params, lpips_params) on the device: the VQVAE
        from `seed`, the discriminator from seed + 1, LPIPS's random weights
        from lpips_seed (seed + 2 when None)."""
        vq_params = self.vqvae.init_params(seed)
        disc_params = tree_to(disc_mod.init_params(generator_for(seed + 1)), self.device)
        lp_seed = seed + 2 if lpips_seed is None else lpips_seed
        lpips_params = tree_to(lpips_mod.init_params(generator_for(lp_seed)), self.device)
        return vq_params, disc_params, lpips_params

    def _usage_pct(self, usage: Dict, batch: int) -> torch.Tensor:
        """The mean over scales of the codebook's used share, in percent."""
        tok = batch * self.vqvae.cfg.patch_nums[-1] ** 2
        return torch.mean(self.vqvae.quantizer.usage_percent(usage, tok))

    @staticmethod
    def _last_layer_norms(nll: torch.Tensor, gan: torch.Tensor, last: torch.Tensor):
        """(||d nll / d last||, ||d gan / d last||), without gradient; the
        graph is kept for the total loss's backward."""
        g_nll, = torch.autograd.grad(nll, last, retain_graph=True)
        g_gan, = torch.autograd.grad(gan, last, retain_graph=True)
        return torch.linalg.vector_norm(g_nll), torch.linalg.vector_norm(g_gan)


class VQVAETrainStep(_GANStep):
    """Single-codebook VQVAE G/D training."""

    def init_state(self, seed: int, lpips_seed=None) -> Tuple[GANTrainState, Params]:
        vq_params, disc_params, lpips_params = self._init_trees(seed, lpips_seed)
        vq_opt, disc_opt = self.make_optimizers(vq_params, disc_params)
        state = GANTrainState(vq_params, disc_params, vq_opt, disc_opt, 0,
                              self.vqvae.quantizer.init_usage_state(self.device))
        return state, lpips_params

    def g_step(self, state: GANTrainState, lpips_params: Params, images) -> Tuple[
            GANTrainState, Dict]:
        """One generator update, in place. images: (B, H, W, 3) in [-1, 1]."""
        images = to_device(images, self.device)
        lw = self.loss
        state.vq_opt.zero_grad(set_to_none=True)
        recon, vq_loss, hits = self.vqvae.forward_train(state.vq_params, images)
        nll_only = (torch.mean(torch.abs(images - recon)) * lw.pixel_weight
                    + lw.perceptual_weight * torch.mean(lpips_distance(lpips_params, images,
                                                                       recon)))
        gan_only = -torch.mean(disc_mod.apply(state.disc_params, recon))
        norms = self._last_layer_norms(nll_only, gan_only, _leaf(state.vq_params))
        loss, metrics = lw.generator_loss(lpips_params, state.disc_params, images, recon,
                                          vq_loss, state.step, last_layer_grads=norms)
        _backward_into(loss, state.vq_params)
        state.vq_opt.step()
        # codebook-usage EMA + vocab percentage, as the reference's quantizer
        # tracks during VAE training (reference: models/quant.py:75-101)
        q = self.vqvae.quantizer
        state.usage = q.update_usage(state.usage, hits)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(usage_pct=self._usage_pct(state.usage, images.shape[0]),
                       entropy_reg=q.entropy_loss(state.usage))
        return state, metrics

    def d_step(self, state: GANTrainState, images) -> Tuple[GANTrainState, Dict]:
        """One discriminator update on the updated VQVAE's reconstruction,
        in place; the step count advances."""
        images = to_device(images, self.device)
        with torch.no_grad():
            recon, _, _ = self.vqvae.forward_train(state.vq_params, images)
        state.disc_opt.zero_grad(set_to_none=True)
        loss, metrics = self.loss.discriminator_loss(state.disc_params, images, recon,
                                                     state.step)
        loss.backward()
        state.disc_opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}


class MaskVQVAETrainStep(_GANStep):
    """Dual-codebook (MaskVQVAE) tokenizer training, the reference's primary
    train_vqvae.py loop (reference: train_vqvae.py:105-158): joint image +
    mask reconstruction with L1/LPIPS/GAN terms averaged over both branches
    and the codebook loss over the two books. Tracks each codebook's usage
    EMA; entropy_weight > 0 adds -entropy_weight * H(usage) to the loss
    (defined but unused by the reference trainers too)."""

    def __init__(self, vqvae, loss: VQLPIPSWithDiscriminator, lr: float = 1e-4,
                 entropy_weight: float = 0.0):
        super().__init__(vqvae, loss, lr)
        self.entropy_weight = entropy_weight

    def init_state(self, seed: int, lpips_seed=None) -> Tuple[DualGANTrainState, Params]:
        vq_params, disc_params, lpips_params = self._init_trees(seed, lpips_seed)
        vq_opt, disc_opt = self.make_optimizers(vq_params, disc_params)
        q = self.vqvae.quantizer
        state = DualGANTrainState(vq_params, disc_params, vq_opt, disc_opt, 0,
                                  q.init_usage_state(self.device),
                                  q.init_usage_state(self.device))
        return state, lpips_params

    def g_step(self, state: DualGANTrainState, lpips_params: Params, images, masks):
        """One generator update over the joint forward, in place. Returns
        (state, metrics, (recon_img, recon_msk)) with the reconstructions of
        the params before the update, detached, for the D step."""
        images, masks = to_device(images, self.device), to_device(masks, self.device)
        lw = self.loss
        state.vq_opt.zero_grad(set_to_none=True)
        ri, rm, (hits, m_hits), mvq, vq = self.vqvae.forward_train_joint(
            state.vq_params, images, masks)
        rec = 0.5 * (torch.mean(torch.abs(images - ri)) + torch.mean(torch.abs(masks - rm)))
        per = 0.5 * (torch.mean(lpips_distance(lpips_params, images, ri))
                     + torch.mean(lpips_distance(lpips_params, masks, rm)))
        nll_only = rec * lw.pixel_weight + lw.perceptual_weight * per
        gan_only = -torch.mean(0.5 * (disc_mod.apply(state.disc_params, ri)
                                      + disc_mod.apply(state.disc_params, rm)))
        norms = self._last_layer_norms(nll_only, gan_only, _leaf(state.vq_params))
        loss, metrics = lw.generator_loss_dual(lpips_params, state.disc_params, images, masks,
                                               ri, rm, vq, mvq, state.step,
                                               last_layer_grads=norms)
        q = self.vqvae.quantizer
        if self.entropy_weight > 0:
            ent = q.entropy_loss(q.update_usage(state.usage, hits))
            loss = loss - self.entropy_weight * ent
            metrics = dict(metrics, entropy=ent)
        _backward_into(loss, state.vq_params)
        state.vq_opt.step()
        state.usage = q.update_usage(state.usage, hits)
        state.mask_usage = q.update_usage(state.mask_usage, m_hits)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(usage_pct=self._usage_pct(state.usage, images.shape[0]),
                       mask_usage_pct=self._usage_pct(state.mask_usage, images.shape[0]),
                       entropy_reg=q.entropy_loss(state.usage))
        return state, metrics, (ri.detach(), rm.detach())

    def d_step(self, state: DualGANTrainState, images, masks, recon_img, recon_msk):
        """One discriminator update, in place; the step count advances."""
        images, masks = to_device(images, self.device), to_device(masks, self.device)
        state.disc_opt.zero_grad(set_to_none=True)
        loss, metrics = self.loss.discriminator_loss_dual(state.disc_params, images, masks,
                                                          recon_img, recon_msk, state.step)
        loss.backward()
        state.disc_opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}
