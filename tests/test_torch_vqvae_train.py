"""The port's tokenizer training against the JAX package, fp32 on the CPU,
on the same weights: the quantizer's training half (quantize_train's
straight-through output, loss, hit counts and gradients; encode_fhat,
ids_to_fhat, embed_to_fhat in both modes; the usage EMA, usage percent and
entropy), the VQVAE's recon entry points, MaskVQVAE's joint forward and
export, one MaskVQVAETrainStep G + D step, and `CheckpointIO` on its state.

The trees are the port's init (`MaskVQVAE.init_params`) carried to the
JAX layout (conv kernels OIHW -> HWIO), since the JAX package's eager inits
take ~25 s. Tolerances: token ids, hit counts and usage EMAs bit for bit;
feature maps and losses to 1e-5 relative to their largest magnitude plus
1e-6 absolute, the adaptive weight to D_WEIGHT_RTOL (below);
decoded images to 1e-4 of theirs (fp32 reassociation through the ~30 convs
of a ch-32 decoder, as tests/test_torch_vqvae.py holds fhat_to_img);
gradients by `grad_close` (a relative L2 error of 2e-3 per leaf, each
element within 1e-2 of the leaf's largest, plus 1e-5 of the tree's largest
gradient: a leaf whose exact gradient is 0, a conv bias under a
one-channel GroupNorm or before the discriminator's BatchNorm, holds only
fp32 noise of the whole backward, measured up to ~1e-6 of the tree's
largest; the function's docstring says why a G step's gradients are
jumpy). Adam's first step moves each element by lr * g / (|g| + 1e-8),
about lr * sign(g): params after it are held to lr * 1e-2 where |g| is
clear of that noise (above 1e-2 of the leaf's largest gradient and 1e-3
of the tree's), and to the step's own bound, 2 lr, elsewhere, where the
noise can flip a sign."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlvar_tpu.ckpt import torch_export as jexport
from controlvar_tpu.config import VQVAEConfig as JVQCfg
from controlvar_tpu.losses.vqperceptual import VQLPIPSWithDiscriminator as JLoss
from controlvar_tpu.models.quantizer import MultiScaleQuantizer as JQuant
from controlvar_tpu.models.vqvae_mask import MaskVQVAE as JMaskVQVAE
from controlvar_tpu.train.train_vqvae import DualGANTrainState as JDualState
from controlvar_tpu.train.train_vqvae import MaskVQVAETrainStep as JMaskStep

from controlvar_tpu_torch.ckpt import torch_export
from controlvar_tpu_torch.ckpt.orbax_io import CheckpointIO
from controlvar_tpu_torch.config import VQVAEConfig
from controlvar_tpu_torch.losses.vqperceptual import VQLPIPSWithDiscriminator
from controlvar_tpu_torch.models.quantizer import MultiScaleQuantizer
from controlvar_tpu_torch.models.vqvae_mask import MaskVQVAE
from controlvar_tpu_torch.train.param_groups import named_leaves
from controlvar_tpu_torch.train.train_vqvae import DualGANTrainState, MaskVQVAETrainStep

VQ = dict(ch=32, patch_nums=(1, 2, 4), vocab_size=64)
LR = 1e-4
# The adaptive weight is ||d nll/dw|| / ||d gan/dw|| at the decoder's
# output conv. The two packages' reconstructions differ by ~1e-4 of their
# magnitude, which moves a few of the discriminator's pre-activations
# across LeakyReLU's kink, so the GAN term's gradient differs by up to
# ~5e-3 in a few elements and its norm by ~6e-4 (on the same
# reconstruction the discriminator's input gradients agree to 2e-6).
D_WEIGHT_RTOL = 2e-3

@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs several workers on the machine's cores; torch's
    default pool of one thread a core in each oversubscribes them (a
    twelvefold slowdown of this file's torch work under six workers)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)



def to_jax(tree):
    """A port tree as numpy in the JAX layout: every "kernel" is a conv,
    OIHW -> HWIO; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: (v.detach().numpy().transpose(2, 3, 1, 0) if k == "kernel"
                    else to_jax(v)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_jax(v) for v in tree]
    return tree.detach().numpy()


def leaf_dict(tree):
    """{"a/b/0/c": numpy} of a JAX-layout tree, named as named_leaves names."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in path):
            np.asarray(leaf) for path, leaf in flat}


def close(got, want, rel, what="", floor=0.0):
    """|got - want| <= rel * max|want| + floor, elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale + floor, err_msg=what)


@pytest.fixture(scope="module")
def tokenizer():
    """(port MaskVQVAE, its params, the JAX MaskVQVAE, the params as JAX arrays)."""
    vq = MaskVQVAE(VQVAEConfig(**VQ), device="cpu")
    params = vq.init_params(0)
    return vq, params, JMaskVQVAE(JVQCfg(**VQ)), jax.tree_util.tree_map(
        jnp.asarray, to_jax(params))


def _images(seed, B=2, hw=64):
    return (np.random.default_rng(seed).random((B, hw, hw, 3)) * 2 - 1).astype(np.float32)


def _features(seed, B=2):
    return np.random.default_rng(seed).normal(0, 1, (B, 4, 4, 32)).astype(np.float32)


def test_quantize_train_matches_jax(tokenizer):
    """f_hat_st, vq_loss and hits, then the gradients of sum(r * f_hat_st) +
    vq_loss into the codebook, the phis and f (straight-through: f's
    gradient is r plus the commitment term's)."""
    _, params, _, jparams = tokenizer
    cfg = VQVAEConfig(**VQ)
    q, jq = MultiScaleQuantizer(cfg), JQuant(JVQCfg(**VQ))
    f_np = _features(1)
    r = np.random.default_rng(2).normal(0, 1, f_np.shape).astype(np.float32)

    def jloss(qp, f):
        fh, vq_loss, hits = jq.quantize_train(qp, f)
        return jnp.sum(fh * r) + vq_loss, (fh, vq_loss, hits)

    (jl, (jfh, jvq, jhits)), (jg_q, jg_f) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jparams["quantize"], jnp.asarray(f_np))
    qp = {k: ([{kk: t.clone().requires_grad_(True) for kk, t in phi.items()} for phi in v]
              if k == "phi" else v.clone().requires_grad_(True))
          for k, v in params["quantize"].items()}
    f = torch.from_numpy(f_np).requires_grad_(True)
    fh, vq_loss, hits = q.quantize_train(qp, f)
    (torch.sum(fh * torch.from_numpy(r)) + vq_loss).backward()
    np.testing.assert_array_equal(hits.numpy(), np.asarray(jhits))
    assert hits.sum(-1).tolist() == [2 * pn * pn for pn in VQ["patch_nums"]]
    close(fh.detach(), jfh, 1e-5, "f_hat_st")
    close(vq_loss.detach(), jvq, 1e-5, "vq_loss")
    close(f.grad, jg_f, 1e-4, "grad f")
    got = {k: (g.grad.numpy() if k == "embedding" else None) for k, g in qp.items()}
    close(got["embedding"], jg_q["embedding"], 1e-4, "grad embedding")
    used = set(q._phi_table)
    for i, phi in enumerate(qp["phi"]):
        if i not in used:  # a phi no scale uses: no gradient, JAX's is zero
            assert phi["kernel"].grad is None and not np.asarray(jg_q["phi"][i]["kernel"]).any()
            continue
        close(phi["kernel"].grad.numpy().transpose(2, 3, 1, 0), jg_q["phi"][i]["kernel"],
              1e-4, f"grad phi {i}")
        close(phi["bias"].grad, jg_q["phi"][i]["bias"], 1e-4, f"grad phi bias {i}")


def test_encode_fhat_and_ids_to_fhat_match_jax(tokenizer):
    _, params, _, jparams = tokenizer
    q, jq = MultiScaleQuantizer(VQVAEConfig(**VQ)), JQuant(JVQCfg(**VQ))
    f_np = _features(3)
    got, want = q.encode_fhat(params["quantize"], torch.from_numpy(f_np)), jq.encode_fhat(
        jparams["quantize"], jnp.asarray(f_np))
    assert len(got) == len(want) == 3
    for si, (a, b) in enumerate(zip(got, want)):
        close(a, b, 1e-5, f"f_hat scale {si}")
    ids = q.encode_ids(params["quantize"], torch.from_numpy(f_np))
    fh = q.ids_to_fhat(params["quantize"], ids)
    close(fh, jq.ids_to_fhat(jparams["quantize"], [jnp.asarray(i.numpy()) for i in ids]),
          1e-5, "ids_to_fhat")
    close(fh, got[-1], 1e-5, "ids_to_fhat vs the encode's last f_hat")


@pytest.mark.parametrize("all_to_max_scale", [True, False])
@pytest.mark.parametrize("last_one", [True, False])
def test_embed_to_fhat_matches_jax(tokenizer, all_to_max_scale, last_one):
    _, params, _, jparams = tokenizer
    q, jq = MultiScaleQuantizer(VQVAEConfig(**VQ)), JQuant(JVQCfg(**VQ))
    rng = np.random.default_rng(4)
    ms_h = [rng.normal(0, 1, (2, pn, pn, 32)).astype(np.float32) for pn in VQ["patch_nums"]]
    got = q.embed_to_fhat(params["quantize"], [torch.from_numpy(h) for h in ms_h], last_one,
                          all_to_max_scale)
    want = jq.embed_to_fhat(jparams["quantize"], [jnp.asarray(h) for h in ms_h], last_one,
                            all_to_max_scale)
    got, want = ([got], [want]) if last_one else (got, want)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for a, b in zip(got, want):
        close(a, b, 1e-5)


def test_vqvae_recon_entry_points_match_jax(tokenizer):
    vq, params, jvq, jparams = tokenizer
    img = _images(5)
    t, j = torch.from_numpy(img), jnp.asarray(img)
    close(vq.img_to_recon(params, t), jvq.img_to_recon(jparams, j), 1e-4, "img_to_recon")
    ms, jms = vq.img_to_ms_recon(params, t), jvq.img_to_ms_recon(jparams, j)
    assert len(ms) == len(jms) == 3
    for si, (a, b) in enumerate(zip(ms, jms)):
        close(a, b, 1e-4, f"img_to_ms_recon scale {si}")
    ids = vq.img_to_ids(params, t)
    close(vq.ids_to_img(params, ids),
          jvq.ids_to_img(jparams, [jnp.asarray(i.numpy()) for i in ids]), 1e-4, "ids_to_img")
    recon, vq_loss, hits = vq.forward_train(params, t)
    jrecon, jvq_loss, jhits = jvq.forward_train(jparams, j)
    close(recon.detach(), jrecon, 1e-4, "forward_train recon")
    close(vq_loss.detach(), jvq_loss, 1e-5, "forward_train vq_loss")
    np.testing.assert_array_equal(hits.numpy(), np.asarray(jhits))


def test_usage_ema_schedule_matches_jax():
    """105 updates: the copy at the first, rate 0.1 to the 100th, 0.01
    after; usage percent and entropy at each."""
    q, jq = MultiScaleQuantizer(VQVAEConfig(**VQ)), JQuant(JVQCfg(**VQ))
    state, jstate = q.init_usage_state("cpu"), jq.init_usage_state()
    rng = np.random.default_rng(6)
    for i in range(105):
        hits = rng.poisson(0.5, (3, 64)).astype(np.float32)
        state, jstate = q.update_usage(state, torch.from_numpy(hits)), jq.update_usage(
            jstate, jnp.asarray(hits))
        assert int(state["record_hit"]) == int(jstate["record_hit"]) == i + 1
        np.testing.assert_allclose(state["ema_hits"].numpy(), np.asarray(jstate["ema_hits"]),
                                   rtol=1e-6, atol=1e-7, err_msg=f"update {i}")
        np.testing.assert_array_equal(q.usage_percent(state, 32).numpy(),
                                      np.asarray(jq.usage_percent(jstate, 32)))
        np.testing.assert_allclose(float(q.entropy_loss(state)),
                                   float(jq.entropy_loss(jstate)), rtol=1e-6)
        if i == 0:
            np.testing.assert_array_equal(state["ema_hits"].numpy(), hits)
    assert state["record_hit"].dtype == torch.int32


def test_forward_train_joint_matches_jax(tokenizer):
    vq, params, jvq, jparams = tokenizer
    img, msk = _images(7), _images(8)
    ri, rm, (hits, m_hits), mvq, vql = vq.forward_train_joint(
        params, torch.from_numpy(img), torch.from_numpy(msk))
    jri, jrm, (jhits, jm_hits), jmvq, jvql = jvq.forward_train_joint(
        jparams, jnp.asarray(img), jnp.asarray(msk))
    np.testing.assert_array_equal(hits.numpy(), np.asarray(jhits))
    np.testing.assert_array_equal(m_hits.numpy(), np.asarray(jm_hits))
    for name, a, b, tol in (("recon_img", ri, jri, 1e-4), ("recon_msk", rm, jrm, 1e-4),
                            ("mask_vq_loss", mvq, jmvq, 1e-5), ("vq_loss", vql, jvql, 1e-5)):
        close(a.detach(), b, tol, name)
    # the mask branch's decode carries no gradient; the image's does
    assert rm.grad_fn is None and not rm.requires_grad
    params_g = MaskVQVAE(VQVAEConfig(**VQ), device="cpu").init_params(0)
    for _, leaf in named_leaves(params_g):
        leaf.requires_grad_(True)
    ri, *_ = vq.forward_train_joint(params_g, torch.from_numpy(img), torch.from_numpy(msk))
    assert ri.requires_grad


def test_mask_vqvae_init_and_export_match_jax(tokenizer):
    vq, params, _, jparams = tokenizer
    assert set(params) == {"encoder", "decoder", "quantize", "quant_conv", "post_quant_conv",
                           "mask_quantize", "filter"}
    # the base VQVAE's leaves are the plain VQVAE's init from the same seed
    from controlvar_tpu_torch.models.vqvae import VQVAE

    plain = dict(named_leaves(VQVAE(VQVAEConfig(**VQ), device="cpu").init_params(0)))
    for name, leaf in named_leaves(params):
        if name in plain:
            assert torch.equal(leaf, plain[name]), name
    rng = np.random.default_rng(9)
    usage = {"ema_hits": rng.random((3, 64)).astype(np.float32)}
    mask_usage = {"ema_hits": rng.random((3, 64)).astype(np.float32)}
    cfg, jcfg = VQVAEConfig(**VQ), JVQCfg(**VQ)
    for u, mu in ((None, None), (usage, mask_usage)):
        got = torch_export.export_mask_vqvae_state_dict(
            params, cfg, usage=None if u is None else {"ema_hits": torch.from_numpy(u[
                "ema_hits"])}, mask_usage=None if mu is None else {
                "ema_hits": torch.from_numpy(mu["ema_hits"])})
        want = jexport.export_mask_vqvae_state_dict(to_jax(params), jcfg, usage=u,
                                                    mask_usage=mu)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def grad_close(g, want, floor, what):
    """A gradient leaf against JAX's: relative L2 error <= 2e-3 and each
    element within 1e-2 of the leaf's largest, both plus `floor` (1e-5 of
    the tree's largest gradient) per element. Returns the relative L2 error
    of a leaf above the floor. ReLU kinks make the G step's gradients
    jumpy: the two packages' reconstructions differ by ~1e-4 of their
    magnitude, which moves a few of LPIPS's (and the discriminator's)
    pre-activations across a kink, and each such unit passes all or none
    of its gradient (measured: a few elements of a decoder bias at ~1e-3 of
    the leaf's largest; on the same input the two agree to ~1e-6)."""
    err = np.abs(g - want)
    scale = float(np.abs(want).max())
    assert err.max() <= 1e-2 * scale + floor, f"{what}: {err.max():.3e} of {scale:.3e}"
    l2, l2_want = float(np.linalg.norm(err)), float(np.linalg.norm(want))
    assert l2 <= 2e-3 * l2_want + floor * np.sqrt(err.size), (
        f"{what}: L2 error {l2:.3e} of {l2_want:.3e}")
    return l2 / max(l2_want, 1e-30) if l2_want > floor * np.sqrt(err.size) else 0.0


def _grads(tree):
    """{name: grad} of a tree's leaves; a leaf the loss does not reach (a
    phi no scale uses) has none, where JAX's gradient is zero."""
    return {n: torch.zeros_like(leaf) if leaf.grad is None else leaf.grad.clone()
            for n, leaf in named_leaves(tree)}


@pytest.fixture(scope="module")
def dual_step_result(tokenizer):
    """One G + D step of each package's MaskVQVAETrainStep from the same
    params (discriminator and LPIPS from the port's seeds), entropy_weight
    0.1. The G step's GAN term is gated off (disc_start past the step; the
    adaptive weight is still computed; the D steps run ungated), as
    tests/test_torch_losses.py::test_vqvae_train_step_matches_jax says why;
    its gradient is held on one input there."""
    vq, _, jvq, _ = tokenizer
    loss = dict(disc_start=1000)
    step = MaskVQVAETrainStep(vq, VQLPIPSWithDiscriminator(**loss), lr=LR, entropy_weight=0.1)
    state, lpips_params = step.init_state(0)
    jstep = JMaskStep(jvq, JLoss(**loss), lr=LR, entropy_weight=0.1)
    # the D steps with the gate open (they take the same reconstructions)
    d_step = MaskVQVAETrainStep(vq, VQLPIPSWithDiscriminator(disc_start=0), lr=LR)
    jd_step = JMaskStep(jvq, JLoss(disc_start=0), lr=LR)
    jv, jd = (jax.tree_util.tree_map(jnp.asarray, to_jax(t))
              for t in (state.vq_params, state.disc_params))
    tx, jvo, jdo = jstep.make_optimizers(jv, jd)
    q = jvq.quantizer
    jstate = JDualState(jv, jd, jvo, jdo, jnp.zeros((), jnp.int32), q.init_usage_state(),
                        q.init_usage_state())
    jlp = jax.tree_util.tree_map(jnp.asarray, to_jax(lpips_params))
    img, msk = _images(10), _images(11)
    jstate, jgm, (jri, jrm) = jax.jit(
        lambda s, lp, im, mk: jstep.g_step(tx, s, lp, im, mk))(jstate, jlp, img, msk)
    jstate, jdm = jax.jit(lambda s, im, mk, ri, rm: jd_step.d_step(tx, s, im, mk, ri, rm))(
        jstate, img, msk, jri, jrm)
    state, gm, (ri, rm) = step.g_step(state, lpips_params, torch.from_numpy(img),
                                      torch.from_numpy(msk))
    vq_grads = _grads(state.vq_params)
    state, dm = d_step.d_step(state, torch.from_numpy(img), torch.from_numpy(msk), ri, rm)
    disc_grads = _grads(state.disc_params)
    return dict(state=state, gm=gm, dm=dm, vq_grads=vq_grads, disc_grads=disc_grads,
                jstate=jstate, jgm=jgm, jdm=jdm, recon=(ri, rm), jrecon=(jri, jrm))


def test_dual_step_metrics_match_jax(dual_step_result):
    r = dual_step_result
    gm, jgm, dm, jdm = r["gm"], r["jgm"], r["dm"], r["jdm"]
    assert set(gm) == set(jgm) and set(dm) == set(jdm)
    for k in jgm:
        close(gm[k], jgm[k], D_WEIGHT_RTOL if k == "d_weight" else 1e-5, k, 1e-6)
    for k in jdm:
        close(dm[k], jdm[k], 1e-5, k, 1e-6)
    assert 0 < float(gm["usage_pct"]) <= 100 and float(gm["d_weight"]) > 0
    assert float(dm["d_loss"]) > 0.0
    for a, b in zip(r["recon"], r["jrecon"]):
        close(a, b, 1e-4, "recon")
    state, jstate = r["state"], r["jstate"]
    assert state.step == int(jstate.step) == 1
    for mine, theirs in ((state.usage, jstate.usage), (state.mask_usage, jstate.mask_usage)):
        np.testing.assert_array_equal(mine["ema_hits"].numpy(), np.asarray(theirs["ema_hits"]))
        assert int(mine["record_hit"]) == int(theirs["record_hit"]) == 1


def _adam_grads(opt_state, params_like):
    """The gradient of optax's first Adam step from its first moment:
    mu = (1 - b1) g with b1 = 0.5, exact in fp32."""
    mu = opt_state[0].mu
    return {k: 2.0 * v for k, v in leaf_dict(mu).items()}


@pytest.mark.parametrize("tree", ["vq", "disc"])
def test_dual_step_grads_and_params_match_jax(dual_step_result, tree):
    r = dual_step_result
    state, jstate = r["state"], r["jstate"]
    grads = r["vq_grads"] if tree == "vq" else r["disc_grads"]
    jopt = jstate.vq_opt if tree == "vq" else jstate.disc_opt
    params = state.vq_params if tree == "vq" else state.disc_params
    jparams = jstate.vq_params if tree == "vq" else jstate.disc_params
    jgrads = _adam_grads(jopt, jparams)
    assert set(grads) == set(jgrads)
    floor = 1e-5 * max(float(np.abs(g).max()) for g in jgrads.values())
    worst, worst_rel = 0.0, 0.0
    for name, g in grads.items():
        g = g.numpy()
        want = jgrads[name]
        if g.ndim == 4:
            g = g.transpose(2, 3, 1, 0)
        worst_rel = max(worst_rel, grad_close(g, want, floor, f"grad {name}"))
        diff = np.abs(params_of(params, name) - leaf_dict(jparams)[name])
        clear = np.abs(want) > max(1e-2 * float(np.abs(want).max()), 1e2 * floor)
        if clear.any():
            worst = max(worst, float(diff[clear].max()))
        assert not (diff[clear] > LR * 1e-2).any(), f"param {name}: {diff[clear].max():.3e}"
        assert diff.max() <= 2 * LR * (1 + 1e-5), f"param {name}: {diff.max():.3e}"
    print(f"{tree}: largest gradient relative L2 error {worst_rel:.3e}; largest param "
          f"difference after Adam where |g| is clear of the noise: {worst:.3e} (lr {LR:g})")


def params_of(tree, name):
    leaf = dict(named_leaves(tree))[name].detach().numpy()
    return leaf.transpose(2, 3, 1, 0) if leaf.ndim == 4 else leaf


@pytest.mark.parametrize("kind", ["single", "dual"])
def test_gan_state_checkpoint_round_trip_and_resume(tokenizer, tmp_path, kind):
    """CheckpointIO on a GANTrainState (VQVAETrainStep) and a
    DualGANTrainState (MaskVQVAETrainStep): both trees (the discriminator's
    None BatchNorm entries kept), both Adam states, the step and the usage
    trees come back bit for bit into a fresh state, and a G + D step from
    the restored state equals one from the saved state."""
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.train.train_vqvae import GANTrainState, VQVAETrainStep

    img, msk = torch.from_numpy(_images(12)), torch.from_numpy(_images(13))
    loss = VQLPIPSWithDiscriminator(disc_start=0)
    if kind == "dual":
        step = MaskVQVAETrainStep(tokenizer[0], loss, lr=LR)

        def run(state, lpips_params):
            state, _, (ri, rm) = step.g_step(state, lpips_params, img, msk)
            return step.d_step(state, img, msk, ri, rm)[0]
    else:
        step = VQVAETrainStep(VQVAE(VQVAEConfig(**VQ), device="cpu"), loss, lr=LR)

        def run(state, lpips_params):
            state, _ = step.g_step(state, lpips_params, img)
            return step.d_step(state, img)[0]

    state, lpips_params = step.init_state(3)
    assert state.disc_params["layers"][0]["bn"] is None
    state = run(state, lpips_params)
    io = CheckpointIO(str(tmp_path))
    io.save(1, state, metadata={"epoch": 0})
    fresh, _ = step.init_state(4)
    restored, meta = io.restore(fresh)
    assert meta == {"epoch": 0} and restored.step == 1
    assert type(restored) is (DualGANTrainState if kind == "dual" else GANTrainState)
    assert restored.disc_params["layers"][-1]["bn"] is None
    fields = ("vq_params", "disc_params", "usage") + (("mask_usage",) if kind == "dual" else ())
    for field in fields:
        a, b = dict(named_leaves(getattr(restored, field))), dict(
            named_leaves(getattr(state, field)))
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), f"{field}/{k}"
    for opt in ("vq_opt", "disc_opt"):
        sa, sb = getattr(restored, opt).state_dict(), getattr(state, opt).state_dict()
        assert sa["state"].keys() == sb["state"].keys()
        for i in sa["state"]:
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(sa["state"][i][k], sb["state"][i][k]), (opt, i, k)
    raw, _ = io.restore_raw()
    assert raw["step"] == 1 and raw["disc_params"]["layers"][0]["bn"] is None
    a, b = run(state, lpips_params), run(restored, lpips_params)
    for field in ("vq_params", "disc_params"):
        for (n, x), (_, y) in zip(named_leaves(getattr(a, field)),
                                  named_leaves(getattr(b, field))):
            assert torch.equal(x, y), f"{field}/{n}"
