"""The port's tokenizer losses against the JAX package, fp32 on the CPU, on
the same weights: LPIPS (VGG16 features on 32x32 inputs, the distance and
its input gradient), the PatchGAN discriminator (logits and gradients,
BatchNorm on batch statistics), the hinge and vanilla D losses, the
generator and discriminator losses (single and dual) with the disc_start
gate, the adaptive weight, the segmentation losses, the import of a
synthetic `vgg.pth`-layout state dict in both key layouts, and one
VQVAETrainStep G + D step.

Weights are the port's random inits carried to the JAX layout (conv
kernels OIHW -> HWIO) and back through `from_jax_params(tree, None)`.
Tolerances: activations, logits and losses to 1e-5 of their largest
magnitude (fp32 reassociation through at most 13 convs), the losses plus
1e-6 absolute (the GAN term is a mean of patch logits of either sign,
which cancels to ~0.06 from terms of ~1); gradients to 1e-4
of each leaf's largest gradient plus 1e-5 of the tree's (a conv bias
before BatchNorm has an exact gradient of 0 and holds only fp32 noise);
the train step as tests/test_torch_vqvae_train.py states it."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlvar_tpu.config import VQVAEConfig as JVQCfg
from controlvar_tpu.losses import discriminator as jdisc
from controlvar_tpu.losses import lpips as jlpips
from controlvar_tpu.losses import segmentation as jseg
from controlvar_tpu.losses import vqperceptual as jvqp
from controlvar_tpu.models.vqvae import VQVAE as JVQVAE
from controlvar_tpu.train.train_vqvae import GANTrainState as JGANState
from controlvar_tpu.train.train_vqvae import VQVAETrainStep as JVQStep

from controlvar_tpu_torch.ckpt.convert import from_jax_params
from controlvar_tpu_torch.config import VQVAEConfig
from controlvar_tpu_torch.device import generator_for
from controlvar_tpu_torch.losses import discriminator as disc
from controlvar_tpu_torch.losses import lpips
from controlvar_tpu_torch.losses import segmentation as seg
from controlvar_tpu_torch.losses import vqperceptual as vqp
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.train.param_groups import named_leaves
from controlvar_tpu_torch.train.train_vqvae import GANTrainState, VQVAETrainStep

from test_torch_vqvae_train import (D_WEIGHT_RTOL, _adam_grads, _grads, close, grad_close,
                                    leaf_dict, params_of, to_jax)

LR = 1e-4

@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers on the machine's cores; torch's
    default pool of one thread a core in each oversubscribes them (a
    twelvefold slowdown of this file's torch work under six workers)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)



@pytest.fixture(scope="module")
def nets():
    """(LPIPS params, discriminator params) of the port and as JAX arrays."""
    lp = lpips.init_params(generator_for(0))
    dp = disc.init_params(generator_for(1))
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, to_jax(t))
    return lp, dp, as_jax(lp), as_jax(dp)


def _img(seed, B=2, hw=32):
    return (np.random.default_rng(seed).random((B, hw, hw, 3)) * 2 - 1).astype(np.float32)


def test_from_jax_params_takes_the_loss_trees(nets):
    lp, dp, _, _ = nets
    for tree in (lp, dp):
        back = from_jax_params(to_jax(tree), None, device="cpu")
        a, b = dict(named_leaves(back)), dict(named_leaves(tree))
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert back["layers"][0]["bn"] is None and back["layers"][-1]["bn"] is None
    with pytest.raises(ValueError, match="discriminator or LPIPS"):
        from_jax_params({"stages": []}, None, device="cpu")


def test_vgg_features_and_lpips_match_jax(nets):
    lp, _, jlp, _ = nets
    x, y = _img(0), _img(1)
    feats, jfeats = lpips.vgg_features(lp, torch.from_numpy(x)), jlpips.vgg_features(
        jlp, jnp.asarray(x))
    assert [tuple(f.shape) for f in feats] == [tuple(f.shape) for f in jfeats] == [
        (2, 32, 32, 64), (2, 16, 16, 128), (2, 8, 8, 256), (2, 4, 4, 512), (2, 2, 2, 512)]
    for si, (a, b) in enumerate(zip(feats, jfeats)):
        close(a, b, 1e-5, f"stage {si}")
    xt = torch.from_numpy(x).requires_grad_(True)
    d = lpips.lpips_distance(lp, xt, torch.from_numpy(y))
    d.sum().backward()
    jd, jg = jax.jit(jax.value_and_grad(
        lambda p, a: jlpips.lpips_distance(p, a, jnp.asarray(y)).sum(), argnums=1))(
        jlp, jnp.asarray(x))
    close(d.detach().sum(), jd, 1e-5, "distance")
    close(d.detach(), jlpips.lpips_distance(jlp, jnp.asarray(x), jnp.asarray(y)), 1e-5)
    close(xt.grad, jg, 1e-4, "input gradient")
    same = lpips.lpips_distance(lp, torch.from_numpy(x), torch.from_numpy(x))
    assert float(same.abs().max()) < 1e-6


def test_discriminator_matches_jax(nets):
    _, dp, _, jdp = nets
    x = _img(2, hw=48)
    r = np.random.default_rng(3).normal(0, 1, (2, 4, 4, 1)).astype(np.float32)
    params = {"layers": [{"conv": {k: v.clone().requires_grad_(True)
                                   for k, v in layer["conv"].items()},
                          "bn": None if layer["bn"] is None else {
                              k: v.clone().requires_grad_(True) for k, v in layer["bn"].items()}}
                         for layer in dp["layers"]]}
    out = disc.apply(params, torch.from_numpy(x))
    (out * torch.from_numpy(r)).sum().backward()
    jout, jg = jax.jit(jax.value_and_grad(
        lambda p: (jdisc.apply(p, jnp.asarray(x)) * r).sum()))(jdp)
    jlogits = jdisc.apply(jdp, jnp.asarray(x))
    assert tuple(out.shape) == tuple(jlogits.shape) == (2, 4, 4, 1)
    close(out.detach(), jlogits, 1e-5, "logits")
    jgrads = leaf_dict(jg)
    floor = 1e-5 * max(float(np.abs(g).max()) for g in jgrads.values())
    for name, leaf in named_leaves(params):
        g = leaf.grad.numpy()
        g = g.transpose(2, 3, 1, 0) if g.ndim == 4 else g
        np.testing.assert_allclose(g, jgrads[name], rtol=0,
                                   atol=1e-4 * float(np.abs(jgrads[name]).max()) + floor,
                                   err_msg=name)


def test_discriminator_init_layout():
    p = disc.init_params(generator_for(0))
    layers = p["layers"]
    assert [tuple(layer["conv"]["kernel"].shape) for layer in layers] == [
        (64, 3, 4, 4), (128, 64, 4, 4), (256, 128, 4, 4), (512, 256, 4, 4), (1, 512, 4, 4)]
    assert layers[0]["bn"] is None and layers[-1]["bn"] is None
    assert all(layer["bn"]["scale"].shape == (layer["conv"]["kernel"].shape[0],)
               for layer in layers[1:-1])
    assert 0.015 < float(layers[2]["conv"]["kernel"].std()) < 0.025


def test_d_losses_and_adaptive_weight_match_jax():
    rng = np.random.default_rng(4)
    real, fake = (rng.normal(0, 2, (2, 6, 6, 1)).astype(np.float32) for _ in range(2))
    for mine, theirs in ((vqp.hinge_d_loss, jvqp.hinge_d_loss),
                         (vqp.vanilla_d_loss, jvqp.vanilla_d_loss)):
        close(mine(torch.from_numpy(real), torch.from_numpy(fake)),
              theirs(jnp.asarray(real), jnp.asarray(fake)), 1e-6, mine.__name__)
    h = float(vqp.hinge_d_loss(torch.tensor([2.0, -0.5]), torch.tensor([-2.0, 0.5])))
    np.testing.assert_allclose(h, 0.75, rtol=1e-6)
    loss, jloss = vqp.VQLPIPSWithDiscriminator(), jvqp.VQLPIPSWithDiscriminator()
    for a, b in ((0.3, 0.7), (5.0, 1e-9), (0.0, 2.0)):
        close(loss.adaptive_weight(torch.tensor(a), torch.tensor(b)),
              jloss.adaptive_weight(jnp.float32(a), jnp.float32(b)), 1e-6)


@pytest.mark.parametrize("step", [0, 5])
@pytest.mark.parametrize("disc_loss", ["hinge", "vanilla"])
def test_generator_and_discriminator_losses_match_jax(nets, step, disc_loss):
    """The single and dual losses at a step before disc_start (the GAN terms
    gated off) and after it, with and without last-layer gradient norms."""
    lp, dp, jlp, jdp = nets
    kw = dict(disc_start=3, disc_loss=disc_loss, codebook_weight=0.7, perceptual_weight=0.9)
    loss, jloss = vqp.VQLPIPSWithDiscriminator(**kw), jvqp.VQLPIPSWithDiscriminator(**kw)
    x, y, m, n = (_img(s) for s in (5, 6, 7, 8))
    t = lambda a: torch.from_numpy(a)
    cb, mcb, norms = np.float32(0.25), np.float32(0.5), (np.float32(0.3), np.float32(0.2))
    for ll in (None, norms):
        got = loss.generator_loss(lp, dp, t(x), t(y), torch.tensor(cb), step,
                                  None if ll is None else tuple(map(torch.tensor, ll)))
        want = jloss.generator_loss(jlp, jdp, x, y, cb, jnp.int32(step), ll)
        close(got[0].detach(), want[0], 1e-5, "generator loss", 1e-6)
        assert set(got[1]) == set(want[1])
        for k in want[1]:
            close(got[1][k].detach(), want[1][k], 1e-5, k, 1e-6)
        got = loss.generator_loss_dual(lp, dp, t(x), t(m), t(y), t(n), torch.tensor(cb),
                                       torch.tensor(mcb), step,
                                       None if ll is None else tuple(map(torch.tensor, ll)))
        want = jloss.generator_loss_dual(jlp, jdp, x, m, y, n, cb, mcb, jnp.int32(step), ll)
        close(got[0].detach(), want[0], 1e-5, "dual generator loss", 1e-6)
        for k in want[1]:
            close(got[1][k].detach(), want[1][k], 1e-5, k, 1e-6)
    got = loss.discriminator_loss(dp, t(x), t(y), step)
    want = jloss.discriminator_loss(jdp, x, y, jnp.int32(step))
    for k in want[1]:
        close(got[1][k], want[1][k], 1e-5, k, 1e-6)
    got = loss.discriminator_loss_dual(dp, t(x), t(m), t(y), t(n), step)
    want = jloss.discriminator_loss_dual(jdp, x, m, y, n, jnp.int32(step))
    for k in want[1]:
        close(got[1][k], want[1][k], 1e-5, k, 1e-6)
    assert (float(got[0]) == 0.0) == (step < 3)


def test_segmentation_losses_match_jax():
    rng = np.random.default_rng(9)
    logits = rng.normal(0, 3, (3, 8, 8)).astype(np.float32)
    targets = (rng.random((3, 8, 8)) > 0.5).astype(np.float32)
    for mine, theirs in ((seg.dice_loss, jseg.dice_loss), (seg.bce_with_logits,
                                                           jseg.bce_with_logits),
                         (seg.bce_dice_loss, jseg.bce_dice_loss)):
        close(mine(torch.from_numpy(logits), torch.from_numpy(targets)),
              theirs(jnp.asarray(logits), jnp.asarray(targets)), 1e-6, mine.__name__)


@pytest.mark.parametrize("layout", ["slice", "features"])
def test_convert_lpips_state_dict_matches_jax(layout, monkeypatch):
    """A synthetic state dict in the taming-transformers `vgg.pth` layout
    (torch OIHW conv weights, the lin heads as (1, C, 1, 1)), keyed
    net.slice{s}.{i}.* or net.features.{i}.*."""
    rng = np.random.default_rng(10)
    idx = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
    sd, cin = {}, 3
    for si, ((cout, _), convs) in enumerate(zip(lpips.VGG_STAGES, idx)):
        for i in convs:
            pre = f"net.slice{si + 1}.{i}" if layout == "slice" else f"net.features.{i}"
            sd[f"{pre}.weight"] = rng.normal(0, 0.05, (cout, cin, 3, 3)).astype(np.float32)
            sd[f"{pre}.bias"] = rng.normal(0, 0.05, (cout,)).astype(np.float32)
            cin = cout
        sd[f"lin{si}.model.1.weight"] = rng.random((1, cout, 1, 1)).astype(np.float32)
    got = lpips.convert_lpips_state_dict(sd, device="cpu")
    want = jlpips.convert_lpips_state_dict(sd)
    back = from_jax_params(want, None, device="cpu")
    a, b = dict(named_leaves(got)), dict(named_leaves(back))
    assert sorted(a) == sorted(b) and len(a) == 2 * 13 + 5
    for k in a:
        assert torch.equal(a[k], b[k]), k
    x, y = _img(11), _img(12)
    close(lpips.lpips_distance(got, torch.from_numpy(x), torch.from_numpy(y)),
          jlpips.lpips_distance(want, x, y), 1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lpips.convert_lpips_state_dict(sd)


@pytest.mark.parametrize("dual", [False, True])
def test_generator_loss_gradient_matches_jax(nets, dual):
    """The gradient of the generator loss into the reconstructions, with
    the GAN term on (step past disc_start) and adaptive-weight norms given:
    the chain the G step's total loss backpropagates through LPIPS and the
    discriminator, on the same inputs (the whole G steps below run with
    the GAN term gated off, see there)."""
    lp, dp, jlp, jdp = nets
    loss, jloss = vqp.VQLPIPSWithDiscriminator(), jvqp.VQLPIPSWithDiscriminator()
    x, y, m, n = (_img(s) for s in (14, 15, 16, 17))
    norms = (np.float32(0.3), np.float32(0.2))
    tn = tuple(map(torch.tensor, norms))
    yt, nt = torch.from_numpy(y).requires_grad_(True), torch.from_numpy(n).requires_grad_(True)
    if dual:
        got = loss.generator_loss_dual(lp, dp, torch.from_numpy(x), torch.from_numpy(m), yt,
                                       nt, torch.tensor(0.1), torch.tensor(0.2), 1, tn)[0]
        want, (gy, gn) = jax.jit(jax.value_and_grad(
            lambda lpp, dpp, a, b: jloss.generator_loss_dual(lpp, dpp, x, m, a, b, 0.1, 0.2,
                                                             jnp.int32(1), norms)[0],
            argnums=(2, 3)))(jlp, jdp, jnp.asarray(y), jnp.asarray(n))
    else:
        got = loss.generator_loss(lp, dp, torch.from_numpy(x), yt, torch.tensor(0.1), 1, tn)[0]
        want, gy = jax.jit(jax.value_and_grad(
            lambda lpp, dpp, a: jloss.generator_loss(lpp, dpp, x, a, 0.1, jnp.int32(1),
                                                     norms)[0], argnums=2))(
            jlp, jdp, jnp.asarray(y))
    got.backward()
    close(got.detach(), want, 1e-5, "loss", 1e-6)
    close(yt.grad, gy, 1e-4, "gradient into the image reconstruction")
    if dual:
        close(nt.grad, gn, 1e-4, "gradient into the mask reconstruction")


@dataclasses.dataclass(frozen=True)
class _JReconStep(JVQStep):
    """The JAX step whose D step discriminates a given reconstruction."""

    recon: np.ndarray = None

    def _recon(self, vq_params, images, compute_dtype=jnp.float32):
        return jnp.asarray(self.recon), None, None


def test_vqvae_train_step_matches_jax():
    """One VQVAETrainStep G + D step of each package from the same params:
    metrics, gradients before Adam (JAX's from its first moment), params
    after, the usage EMA and the step count.

    The G step's GAN term is gated off (disc_start past the step), while
    the adaptive weight is still computed; the D step runs ungated: the two packages' reconstructions
    differ by ~1e-4 of their magnitude, which moves a few of the
    discriminator's pre-activations across LeakyReLU's kink, and with the
    term on, the encoder's gradients then differ by up to 1e-2 of their
    largest (the term's gradient on one input is held above). The D step
    reconstructs with the G step's updated params, which Adam's first step
    leaves up to 2 lr apart where a gradient is noise (see the tolerances),
    and whose ~1e-4 differences cross LeakyReLU's kinks again: so the JAX D
    step takes the port's reconstruction (`_JReconStep`)."""
    cfg = dict(ch=32, patch_nums=(1, 2, 4), vocab_size=64)
    vqvae = VQVAE(VQVAEConfig(**cfg), device="cpu")
    step = VQVAETrainStep(vqvae, vqp.VQLPIPSWithDiscriminator(disc_start=1000), lr=LR)
    state, lp = step.init_state(0)
    jstep = JVQStep(JVQVAE(JVQCfg(**cfg)), jvqp.VQLPIPSWithDiscriminator(disc_start=1000),
                    lr=LR)
    as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, to_jax(t))
    jv, jd, jlp = (as_jax(t) for t in (state.vq_params, state.disc_params, lp))
    tx, jvo, jdo = jstep.make_optimizers(jv, jd)
    jstate = JGANState(jv, jd, jvo, jdo, jnp.zeros((), jnp.int32),
                       jstep.vqvae.quantizer.init_usage_state())
    img = (np.random.default_rng(13).random((2, 64, 64, 3)) * 2 - 1).astype(np.float32)
    jstate, jgm = jax.jit(lambda s, p, im: jstep.g_step(tx, s, p, im))(jstate, jlp, img)
    state, gm = step.g_step(state, lp, torch.from_numpy(img))
    vq_grads = _grads(state.vq_params)
    jv_after = jstate.vq_params
    # the D steps with the gate open; the JAX one on the port's reconstruction
    d_step = VQVAETrainStep(vqvae, vqp.VQLPIPSWithDiscriminator(disc_start=0), lr=LR)
    with torch.no_grad():
        recon = vqvae.forward_train(state.vq_params, torch.from_numpy(img))[0].numpy()
    jd_step = _JReconStep(jstep.vqvae, jvqp.VQLPIPSWithDiscriminator(disc_start=0), lr=LR,
                          recon=recon)
    jstate, jdm = jax.jit(lambda s, im: jd_step.d_step(tx, s, im))(jstate, img)
    state, dm = d_step.d_step(state, torch.from_numpy(img))
    assert float(dm["d_loss"]) > 0.0
    disc_grads = _grads(state.disc_params)
    assert isinstance(state, GANTrainState) and state.step == int(jstate.step) == 1
    for mine, theirs in ((gm, jgm), (dm, jdm)):
        assert set(mine) == set(theirs)
        for k in theirs:
            close(mine[k], theirs[k], D_WEIGHT_RTOL if k == "d_weight" else 1e-5, k, 1e-6)
    np.testing.assert_array_equal(state.usage["ema_hits"].numpy(),
                                  np.asarray(jstate.usage["ema_hits"]))
    for grads, params, jparams, jopt in ((vq_grads, state.vq_params, jv_after, jstate.vq_opt),
                                         (disc_grads, state.disc_params, jstate.disc_params,
                                          jstate.disc_opt)):
        jgrads = _adam_grads(jopt, jparams)
        assert set(grads) == set(jgrads)
        floor = 1e-5 * max(float(np.abs(g).max()) for g in jgrads.values())
        for name, g in grads.items():
            g = g.numpy()
            g = g.transpose(2, 3, 1, 0) if g.ndim == 4 else g
            want = jgrads[name]
            grad_close(g, want, floor, f"grad {name}")
            diff = np.abs(params_of(params, name) - leaf_dict(jparams)[name])
            clear = np.abs(want) > max(1e-2 * float(np.abs(want).max()), 1e2 * floor)
            assert not (diff[clear] > LR * 1e-2).any(), name
            assert diff.max() <= 2 * LR * (1 + 1e-5), name
