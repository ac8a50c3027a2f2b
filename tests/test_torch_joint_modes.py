"""The port's other two joint modes of ControlVAR against the JAX package:
`sample_joint_cfg` of a `replace` model (mask_factor 1: one stream, one
canvas) and `sample_joint_separate` (`separate_decoding`: the control and
image segments of each scale decoded one after the other).

Both sides run on the CPU in fp32 with the same weights (the port's init,
carried to the JAX side). Greedy sampling (top_k=1) makes the draw
deterministic, so every sampled id must be identical and the canvases agree
to fp32 reassociation noise (atol 1e-4). `more_smooth` cases replace
`gumbel_softmax` on both sides by the noise-free softmax at the same
temperature, as tests/test_torch_joint.py does."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import controlvar_tpu.models.control_var as jax_cv
from controlvar_tpu.config import ControlVARConfig as JCfg, VQVAEConfig as JVQ
from controlvar_tpu.models.vqvae import VQVAE as JVQVAE

import controlvar_tpu_torch.models.control_var as torch_cv
from controlvar_tpu_torch.ckpt.convert import to_jax_params
from controlvar_tpu_torch.config import ControlVARConfig, VQVAEConfig
from controlvar_tpu_torch.eval.stepwise import StepwiseJointSampler
from controlvar_tpu_torch.models.vqvae import VQVAE

PNS = (1, 2, 4)
TINY_VQ = dict(ch=32, patch_nums=PNS, vocab_size=64)
BASE = dict(depth=2, embed_dim=128, num_heads=2, patch_nums=PNS, vocab_size=64, cvae=32,
            num_classes=8)
REPLACE = dict(BASE, mask_factor=1)
SEPARATE = dict(BASE, mask_factor=2, multi_cond=True, separate_decoding=True)


def _vqvae_to_jax(tree):
    """The port's VQVAE params in the JAX layout: every kernel is a conv
    kernel, OIHW -> HWIO (the inverse of `from_jax_params`)."""
    if isinstance(tree, dict):
        return {k: (jnp.asarray(v.numpy().transpose(2, 3, 1, 0)) if k == "kernel"
                    else _vqvae_to_jax(v)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_vqvae_to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def vq():
    tv = VQVAE(VQVAEConfig(**TINY_VQ), device="cpu")
    tvp = tv.init_params(0)
    return dict(jv=JVQVAE(JVQ(**TINY_VQ)), jvp=_vqvae_to_jax(tvp), tv=tv, tvp=tvp)


def _raise_gates(p):
    """At init the AdaLN gate columns are 1e-3 of the rest, which leaves the
    attention output out of the logits (a cache holding K in place of V
    goes unseen); raising the attention gate by 10 and the FFN gate by 1
    makes every layer's attention move the draws and canvases."""
    C = p["blocks"]["ada_lin"]["bias"].shape[1] // 6
    p["blocks"]["ada_lin"]["bias"][:, :C] += 10.0
    p["blocks"]["ada_lin"]["bias"][:, C: 2 * C] += 1.0
    return p


def _models(kw):
    cfg = ControlVARConfig(**kw)
    tm = torch_cv.ControlVARModel(cfg, device="cpu")
    tp = _raise_gates(tm.init_params(1))
    jp = jax.tree_util.tree_map(jnp.asarray, to_jax_params(tp, cfg))
    return jax_cv.ControlVARModel(JCfg(**kw)), tm, jp, tp


def _recorder(monkeypatch):
    """Every draw of both modules' samplers, JAX's by a host callback."""
    calls = {"jax": [], "torch": []}
    j_orig, t_orig = jax_cv.sample_top_k_top_p, torch_cv.sample_top_k_top_p

    def j_spy(*args, **kw):
        out = j_orig(*args, **kw)
        jax.debug.callback(lambda x: calls["jax"].append(np.asarray(x)), out, ordered=True)
        return out

    def t_spy(*args, **kw):
        out = t_orig(*args, **kw)
        calls["torch"].append(out.numpy())
        return out

    monkeypatch.setattr(jax_cv, "sample_top_k_top_p", j_spy)
    monkeypatch.setattr(torch_cv, "sample_top_k_top_p", t_spy)
    return calls


def _noise_free_smoothing(monkeypatch):
    monkeypatch.setattr(jax_cv, "gumbel_softmax",
                        lambda key, logits, tau, hard=False: jax.nn.softmax(
                            logits.astype(jnp.float32) / tau, axis=-1))
    monkeypatch.setattr(torch_cv, "gumbel_softmax",
                        lambda logits, tau, hard=False, generator=None: torch.softmax(
                            logits.float() / tau, dim=-1))


def _compare(calls, n_draws, jout, tout):
    assert len(calls["jax"]) == len(calls["torch"]) == n_draws
    for i, (a, b) in enumerate(zip(calls["jax"], calls["torch"])):
        np.testing.assert_array_equal(a, b, err_msg=f"draw {i}")
    for a, b in zip(jout, tout):
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4, rtol=0)


# case: (config overrides, more_smooth, decode the canvas)
REPLACE_CASES = {"decoded": ({}, False, True),
                 "flat-layout-smooth": (dict(embed_dim=192, num_heads=3), True, False)}


@pytest.mark.parametrize("case", list(REPLACE_CASES))
def test_replace_mode_greedy_matches_jax(vq, monkeypatch, case):
    """mask_factor 1: one stream of pn^2 tokens a scale, one canvas; the
    flat case (three heads of 64) runs K7's plain version."""
    over, smooth, decode = REPLACE_CASES[case]
    jm, tm, jp, tp = _models({**REPLACE, **over})
    if smooth:
        _noise_free_smoothing(monkeypatch)
    calls = _recorder(monkeypatch)
    labels = np.array([1, 6])
    kw = dict(cfg_scale=2.0, top_k=1, top_p=0.0, decode_img=decode, more_smooth=smooth)
    jout = jax.jit(lambda p, vp, l, k: jm.sample_joint_cfg(
        p, vq["jv"], vp, l, None, k, compute_dtype=jnp.float32, **kw))(
        jp, vq["jvp"], jnp.asarray(labels), jax.random.key(4))
    jax.block_until_ready(jout)
    tout = tm.sample_joint_cfg(tp, vq["tv"], vq["tvp"], torch.from_numpy(labels), None,
                               torch.Generator().manual_seed(4), compute_dtype=torch.float32,
                               **kw)
    assert tout.shape == ((2, 64, 64, 3) if decode else (2, 4, 4, 32))
    _compare(calls, len(PNS), [jout], [tout])


SEPARATE_CASES = {"control-first": (True, False, True),
                  "image-first-smooth": (False, True, False)}


@pytest.mark.parametrize("case", list(SEPARATE_CASES))
def test_separate_decoding_greedy_matches_jax(vq, monkeypatch, case):
    """2S transformer calls: each scale's control segment, then its image
    segment fed the control canvas area-resized to the same scale."""
    mask_first, smooth, decode = SEPARATE_CASES[case]
    jm, tm, jp, tp = _models(SEPARATE)
    if smooth:
        _noise_free_smoothing(monkeypatch)
    calls = _recorder(monkeypatch)
    labels, ct = np.array([1, 6]), np.array([0, 3])
    kw = dict(cfg_scale=2.0, top_k=1, top_p=0.0, decode_img=decode, more_smooth=smooth,
              mask_first=mask_first)
    jout = jax.jit(lambda p, vp, l, c, k: jm.sample_joint_separate(
        p, vq["jv"], vp, l, c, k, compute_dtype=jnp.float32, **kw))(
        jp, vq["jvp"], jnp.asarray(labels), jnp.asarray(ct), jax.random.key(5))
    jax.block_until_ready(jout)
    tout = tm.sample_joint_separate(tp, vq["tv"], vq["tvp"], torch.from_numpy(labels),
                                    torch.from_numpy(ct), torch.Generator().manual_seed(5),
                                    compute_dtype=torch.float32, **kw)
    assert tout[0].shape == ((2, 64, 64, 3) if decode else (2, 4, 4, 32))
    _compare(calls, 2 * len(PNS), jout, tout)


def test_joint_mode_dispatch_and_guards(vq):
    """sample_joint_cfg of an interleaved (mask_factor 2) model is the joint
    sampler's output; sample_joint_separate keeps the JAX package's
    asserts."""
    kw = dict(BASE, mask_factor=2, multi_cond=True)
    _, tm, _, tp = _models(kw)
    labels, ct = torch.tensor([1, 6]), torch.tensor([0, 3])
    args = dict(cfg_scale=2.0, top_k=10, top_p=0.9)
    got = tm.sample_joint_cfg(tp, vq["tv"], vq["tvp"], labels, ct, torch.Generator().manual_seed(6),
                              compute_dtype=torch.float32, decode_img=False, **args)
    want = StepwiseJointSampler(tm, vq["tv"], device="cpu", compute_dtype=torch.float32, **args)(
        tp, vq["tvp"], labels, ct, torch.Generator().manual_seed(6), decode_img=False)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for bad, err in ((dict(kw), ValueError),                                   # not separate
                     (dict(SEPARATE, indep=True), ValueError),
                     (dict(SEPARATE, multi_cond=False), ValueError),
                     (dict(SEPARATE, type_pos=True), ValueError),
                     (dict(SEPARATE, separator=True), NotImplementedError)):
        m = torch_cv.ControlVARModel(ControlVARConfig(**bad), device="cpu")
        with pytest.raises(err):
            m.sample_joint_separate(tp, vq["tv"], vq["tvp"], labels, ct, torch.Generator())
