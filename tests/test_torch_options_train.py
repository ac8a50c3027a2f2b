"""Training with the model options against the JAX package: the separator
label layout and ignore-mask splice, and whole fp32 train steps of
separator + type_pos, shared_aln and bidirectional models (both stream
orders), pre-tokenized and pixel, and of a shared_aln VAR.

Both sides start from the same weights (the port's init, carried to the
JAX side with `to_jax_params`) and take the same numpy batches, with cond
drop and drop path off (torch and JAX draw differently). An image-first
step weights its loss by the batch's `ignore_mask_`, which the JAX
trainer hands its step as `ignore_mask`. Tolerances are those of
tests/test_torch_train_step.py: the loss to 1e-5 and grad_norm to 1e-4
relative, every updated leaf to 1e-5 absolute; the label layout and the
splice bit for bit."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlvar_tpu.config import ControlVARConfig as JCfg, OptimConfig as JOptim
from controlvar_tpu.config import VARConfig as JVCfg, VQVAEConfig as JVQCfg
from controlvar_tpu.models.control_var import ControlVARModel as JModel
from controlvar_tpu.models.var import VARModel as JVAR
from controlvar_tpu.models.vqvae import VQVAE as JVQVAE
from controlvar_tpu.train import train_step as jts

from controlvar_tpu_torch.ckpt.convert import from_jax_params, to_jax_params
from controlvar_tpu_torch.config import ControlVARConfig, OptimConfig, VARConfig, VQVAEConfig
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.var import VARModel
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.train import train_step as ts
from controlvar_tpu_torch.train.param_groups import named_leaves

from tests.torch_fixtures import one_torch_thread, vq_to_jax  # noqa: F401

PNS = (1, 2, 4)
VQ = dict(ch=32, patch_nums=PNS, vocab_size=128)
BASE = dict(depth=2, embed_dim=128, num_heads=2, patch_nums=PNS, vocab_size=128, cvae=32,
            num_classes=8, cond_drop_rate=0.0)
SEP_TP = dict(BASE, multi_cond=True, separator=True, type_pos=True)
OPTIM = dict(base_lr=1e-2, total_batch_size=512, grad_clip=1.0)
L_WORDS = 2 * sum(p * p for p in PNS)   # 42 tokens without separators


@pytest.fixture(scope="module")
def vq_tree():
    return vq_to_jax(VQVAE(VQVAEConfig(**VQ), device="cpu").init_params(0))


def _t(xs):
    return [torch.from_numpy(np.asarray(a)) for a in xs]


def _j(xs):
    return [jnp.asarray(a) for a in xs]


@pytest.mark.parametrize("mask_first", [True, False])
def test_interleave_tokens_with_separators_matches_jax(mask_first):
    rng = np.random.default_rng(4)
    pns = (1, 2, 3, 4)
    c_ids = [rng.integers(0, 64, (2, p * p)) for p in pns]
    i_ids = [rng.integers(0, 64, (2, p * p)) for p in pns]
    c_h = [rng.normal(0, 1, (2, p * p, 4)).astype(np.float32) for p in pns[1:]]
    i_h = [rng.normal(0, 1, (2, p * p, 4)).astype(np.float32) for p in pns[1:]]
    labels, x_tf = ts.interleave_tokens(_t(c_ids), _t(i_ids), _t(c_h), _t(i_h), mask_first,
                                        separator=True, vocab_size=64)
    jl, jx = jts.interleave_tokens(_j(c_ids), _j(i_ids), _j(c_h), _j(i_h), mask_first,
                                   separator=True, vocab_size=64)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(x_tf.numpy(), np.asarray(jx))
    assert labels.shape == (2, 66) and x_tf.shape == (2, 58, 4)
    # the separator targets: after each segment of scales 1..3, in the order's mapping
    sep_cols = [2 + 4, 2 + 4 + 1 + 4, 2 + 10 + 9, 2 + 10 + 9 + 1 + 9, 2 + 10 + 20 + 16,
                2 + 10 + 20 + 16 + 1 + 16]
    want = [64 + i for i in ([0, 1, 2, 3, 4, 5] if mask_first else [1, 0, 3, 2, 5, 4])]
    assert labels[0, sep_cols].tolist() == want


def test_splice_separator_ones_and_aligned_ignore_match_jax():
    pns = (1, 2, 3, 4)
    rng = np.random.default_rng(5)
    ign = (rng.random((3, 60)) > 0.3).astype(np.float32)
    got = ts.splice_separator_ones(torch.from_numpy(ign), pns)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jts.splice_separator_ones(
        jnp.asarray(ign), pns)))
    cfg, jcfg = ControlVARConfig(**dict(SEP_TP, patch_nums=pns)), JCfg(**dict(SEP_TP,
                                                                              patch_nums=pns))
    for x in (ign, np.asarray(got)):   # separator-free, then already spliced
        a = ts._aligned_ignore(cfg, torch.from_numpy(x), 66)
        np.testing.assert_array_equal(a.numpy(), np.asarray(jts._aligned_ignore(
            jcfg, jnp.asarray(x), 66)))
    assert ts._aligned_ignore(cfg, None, 66) is None
    with pytest.raises(ValueError, match="columns"):
        ts._aligned_ignore(ControlVARConfig(**dict(BASE, patch_nums=pns)),
                           torch.from_numpy(ign[:, :50]), 60)


def test_image_first_step_needs_the_image_first_ignore_mask():
    a, b = torch.zeros(1, 4), torch.ones(1, 4)
    assert ts._order_ignore({"ignore_mask": a, "ignore_mask_": b}, True) is a
    assert ts._order_ignore({"ignore_mask": a, "ignore_mask_": b}, False) is b
    assert ts._order_ignore({}, False) is None
    with pytest.raises(ValueError, match="ignore_mask_"):
        ts._order_ignore({"ignore_mask": a}, False)


@dataclasses.dataclass(frozen=True)
class _JFp32Model(JModel):
    def forward_train(self, *args, **kwargs):
        return super().forward_train(*args, compute_dtype=jnp.float32, **kwargs)


@dataclasses.dataclass(frozen=True)
class _JFp32VAR(JVAR):
    def forward_train(self, *args, **kwargs):
        return super().forward_train(*args, compute_dtype=jnp.float32, **kwargs)


class _JFp32Step(jts.ControlVARTrainStep):
    tokenize_dtype = jnp.float32


class _JFp32VARStep(jts.VARTrainStep):
    tokenize_dtype = jnp.float32


class _Fp32Step(ts.ControlVARTrainStep):
    tokenize_dtype = torch.float32
    compute_dtype = torch.float32


class _Fp32VARStep(ts.VARTrainStep):
    tokenize_dtype = torch.float32
    compute_dtype = torch.float32


def _batch(seed, from_tokens, ign_len, B=2):
    """A pre-tokenized or pixel batch with both orders' ignore masks of
    ign_len columns (~70% ones, different in the two orders)."""
    rng = np.random.default_rng(seed)
    if from_tokens:
        ids = lambda: [rng.integers(0, 128, (B, p * p)) for p in PNS]
        b = dict(ctrl_ids=ids(), img_ids=ids())
    else:
        img = lambda: (rng.random((B, 64, 64, 3)) * 2 - 1).astype(np.float32)
        b = dict(image=img(), mask=img())
    b.update(cls=rng.integers(0, 8, (B,)), type=rng.integers(0, 4, (B,)))
    for key in ("ignore_mask", "ignore_mask_"):
        b[key] = (rng.random((B, ign_len)) > 0.3).astype(np.float32)
    return b


def _to_jax(batch, mask_first):
    """The batch the JAX trainer hands its step: the order's ignore mask as
    `ignore_mask`, int ids as int32."""
    out = {k: v for k, v in batch.items() if k not in ("ignore_mask", "ignore_mask_")}
    out["ignore_mask"] = batch["ignore_mask" if mask_first else "ignore_mask_"]
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a.astype(np.int32) if a.dtype.kind == "i" else a), out)


def _assert_close(ja, ta, jparams, tparams):
    np.testing.assert_allclose(float(ta["loss"]), float(ja["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(ta["grad_norm"]), float(ja["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(ta["acc"]), float(ja["acc"]), atol=1e-6)
    want = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jparams)))
    got = dict(named_leaves(tparams))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-5, rtol=0, err_msg=name)


# case: (config, pre-tokenized, mask_first, the ignore masks' length)
STEP_CASES = {
    "separator+type_pos-tokens-sep-free-ignore": (SEP_TP, True, True, L_WORDS),
    "separator+type_pos-pixels-spliced-ignore": (SEP_TP, False, True, L_WORDS + 4),
    "bidirectional-mask-first-pixels": (dict(BASE, bidirectional=True), False, True, L_WORDS),
    "bidirectional-image-first-pixels": (dict(BASE, bidirectional=True), False, False, L_WORDS),
    "all-options-image-first-tokens": (dict(SEP_TP, shared_aln=True, bidirectional=True), True,
                                       False, L_WORDS),
    "shared_aln-tokens": (dict(BASE, multi_cond=True, shared_aln=True), True, True, L_WORDS),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_with_options_match_jax(vq_tree, case):
    """Two steps (the second reads the first's AdamW moments) of the port
    and of the JAX step on the same batches and stream order; a separator
    model takes separator-free ignore masks (spliced) or spliced ones."""
    kw, from_tokens, mask_first, ign_len = STEP_CASES[case]
    cfg = ControlVARConfig(**kw)
    tree = to_jax_params(ControlVARModel(cfg, device="cpu").init_params(1), cfg)
    jstep = _JFp32Step(_JFp32Model(JCfg(**kw)), JVQVAE(JVQCfg(**VQ)), JOptim(**OPTIM),
                       max_steps=100, warmup_steps=1)
    jstate, tx = jts.init_train_state(jax.tree_util.tree_map(jnp.asarray, tree), JOptim(**OPTIM))
    tstep = _Fp32Step(ControlVARModel(cfg, device="cpu"), VQVAE(VQVAEConfig(**VQ), device="cpu"),
                      OptimConfig(**OPTIM), max_steps=100, warmup_steps=1, device="cpu")
    tstate = ts.init_train_state(from_jax_params(tree, cfg, device="cpu"), OptimConfig(**OPTIM))
    jvp = jax.tree_util.tree_map(jnp.asarray, vq_tree)
    tvp = from_jax_params(vq_tree, VQVAEConfig(**VQ), device="cpu")
    # one compile for both steps, as the JAX Trainer runs its step
    jfn = jax.jit(lambda s, vp, b, k: jstep.step(tx, s, vp, b, k, mask_first=mask_first,
                                                 from_tokens=from_tokens))
    for i in range(2):
        batch = _batch(30 + i, from_tokens, ign_len)
        jstate, ja = jfn(jstate, jvp, _to_jax(batch, mask_first), jax.random.key(i))
        tstate, ta = tstep.step(tstate, tvp, batch, torch.Generator().manual_seed(i),
                                mask_first=mask_first, from_tokens=from_tokens)
        np.testing.assert_allclose(float(ta["loss"]), float(ja["loss"]), rtol=1e-5)
    _assert_close(ja, ta, jstate.params, to_jax_params(tstate.params, cfg))
    moved = np.abs(to_jax_params(tstate.params, cfg)["blocks"]["qkv_kernel"]
                   - tree["blocks"]["qkv_kernel"]).max()
    assert moved > 1e-3


def test_shared_aln_var_steps_match_jax(vq_tree):
    kw = dict(BASE, shared_aln=True)
    cfg = VARConfig(**kw)
    tree = to_jax_params(VARModel(cfg, device="cpu").init_params(1), cfg)
    assert "shared_ada_lin" in tree and "ada_gss" in tree["blocks"]
    jstep = _JFp32VARStep(_JFp32VAR(JVCfg(**kw)), JVQVAE(JVQCfg(**VQ)), JOptim(**OPTIM),
                          max_steps=100, warmup_steps=1)
    jstate, tx = jts.init_train_state(jax.tree_util.tree_map(jnp.asarray, tree), JOptim(**OPTIM))
    tstep = _Fp32VARStep(VARModel(cfg, device="cpu"), VQVAE(VQVAEConfig(**VQ), device="cpu"),
                         OptimConfig(**OPTIM), max_steps=100, warmup_steps=1, device="cpu")
    tstate = ts.init_train_state(from_jax_params(tree, cfg, device="cpu"), OptimConfig(**OPTIM))
    jvp = jax.tree_util.tree_map(jnp.asarray, vq_tree)
    tvp = from_jax_params(vq_tree, VQVAEConfig(**VQ), device="cpu")
    jfn = jax.jit(lambda s, vp, b, k: jstep.step(tx, s, vp, b, k))
    for i in range(2):
        rng = np.random.default_rng(50 + i)
        batch = dict(image=(rng.random((2, 64, 64, 3)) * 2 - 1).astype(np.float32),
                     cls=rng.integers(0, 8, (2,)))
        jb = {"image": jnp.asarray(batch["image"]), "cls": jnp.asarray(batch["cls"], jnp.int32)}
        jstate, ja = jfn(jstate, jvp, jb, jax.random.key(i))
        tstate, ta = tstep.step(tstate, tvp, batch, torch.Generator().manual_seed(i))
    _assert_close(ja, ta, jstate.params, to_jax_params(tstate.params, cfg))
