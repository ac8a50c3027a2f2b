"""The port's training slice against the JAX package on the same weights
(`from_jax_params`) and the same numpy inputs, fp32 on the CPU, at the tiny
config of tests/test_train.py: the blocks and the teacher-forced forward,
gradients of the CE loss with and without per-layer recompute, the lr/wd
schedules and the weight-decay mask, the token interleave, and whole train
steps (pre-tokenized and pixel) with AdamW. Random draws differ between
torch and JAX, so parity runs with cond drop and drop path off, and those two
are checked by their statistics.

Tolerances: forward values to 1e-4 absolute (fp32 reassociation over two
layers of width 128); gradients to 1e-4 of each leaf's largest gradient; the
loss to 1e-5 and grad_norm to 1e-4 relative; updated params to 1e-5
absolute, lr * 1e-3: AdamW moves each param by lr * m/(sqrt(v) + eps), about
lr = 1e-2 a step here, and normalising each gradient element by its own
magnitude amplifies the fp32 differences of the smallest gradients (the
AdaLN gamma columns, initialised at 1e-3 scale) to up to ~3e-6."""
import dataclasses
from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlvar_tpu.config import ControlVARConfig as JCfg
from controlvar_tpu.config import OptimConfig as JOptim
from controlvar_tpu.config import VQVAEConfig as JVQCfg
from controlvar_tpu.models import transformer as jtfm
from controlvar_tpu.models.control_var import ControlVARModel as JModel
from controlvar_tpu.models.masks import attn_mask_for_config as j_mask_for_config
from controlvar_tpu.models.vqvae import VQVAE as JVQVAE
from controlvar_tpu.train import lr_schedule as jlr
from controlvar_tpu.train.param_groups import weight_decay_mask as j_weight_decay_mask
from controlvar_tpu.train.train_step import ControlVARTrainStep as JTrainStep
from controlvar_tpu.train.train_step import _masked_ce as j_masked_ce
from controlvar_tpu.train.train_step import init_train_state as j_init_train_state
from controlvar_tpu.train.train_step import interleave_tokens as j_interleave_tokens

from controlvar_tpu_torch.ckpt.convert import from_jax_params, to_jax_params
from controlvar_tpu_torch.config import ControlVARConfig, OptimConfig, VQVAEConfig
from controlvar_tpu_torch.models import transformer as tfm
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.train import lr_schedule
from controlvar_tpu_torch.train.param_groups import named_leaves, weight_decay_mask
from controlvar_tpu_torch.train.train_step import (ControlVARTrainStep, init_train_state,
                                                   interleave_tokens)

VQ = dict(ch=32, patch_nums=(1, 2, 4), vocab_size=128)
TINY = dict(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 4), vocab_size=128,
            cvae=32, num_classes=8, mask_factor=2, multi_cond=True)
# parity configs: no random draws (torch and JAX RNGs differ)
NO_DROP = dict(TINY, cond_drop_rate=0.0)
L = 42


@dataclasses.dataclass(frozen=True)
class _JFp32Model(JModel):
    """The JAX model with an fp32 residual stream (its train step always
    takes the default bf16)."""

    def forward_train(self, *args, **kwargs):
        return super().forward_train(*args, compute_dtype=jnp.float32, **kwargs)


class _JFp32Step(JTrainStep):
    tokenize_dtype = jnp.float32


class _Fp32Step(ControlVARTrainStep):
    tokenize_dtype = torch.float32
    compute_dtype = torch.float32


@pytest.fixture(scope="module")
def weights():
    """(JAX params, numpy tree) of the ControlVAR and of the VQVAE."""
    jp = JModel(JCfg(**TINY)).init_params(jax.random.key(1))
    jvp = JVQVAE(JVQCfg(**VQ)).init_params(jax.random.key(0))
    return (jp, jax.tree_util.tree_map(np.asarray, jp),
            jvp, jax.tree_util.tree_map(np.asarray, jvp))


def _port(tree, cfg):
    return from_jax_params(tree, cfg, device="cpu")


def _tokens(seed, B=2):
    rng = np.random.default_rng(seed)
    ids = lambda: [rng.integers(0, TINY["vocab_size"], (B, p * p)) for p in TINY["patch_nums"]]
    return dict(ctrl_ids=ids(), img_ids=ids(), cls=rng.integers(0, 8, (B,)),
                type=rng.integers(0, 4, (B,)))


def _pixels(seed, B=2):
    rng = np.random.default_rng(seed)
    img = lambda: (rng.random((B, 64, 64, 3)) * 2 - 1).astype(np.float32)
    return dict(image=img(), mask=img(), cls=rng.integers(0, 8, (B,)),
                type=rng.integers(0, 4, (B,)))


def _to_jax(batch):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a.astype(np.int32)
                                                        if a.dtype.kind == "i" else a), batch)


def _to_torch(batch):
    return jax.tree_util.tree_map(torch.from_numpy, batch)


def _x_tf(seed, B=2):
    return np.random.default_rng(seed).normal(0, 1, (B, L - 2, 32)).astype(np.float32)


def _leaf_dict(tree):
    """{path: leaf} of a nested tree, path names as the port's named_leaves."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in path): leaf
            for path, leaf in flat}


def _assert_grads_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        w = np.asarray(want[name])
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=name)


def test_blocks_forward_matches_jax(weights):
    jp, tree, _, _ = weights
    cfg, jcfg = ControlVARConfig(**TINY), JCfg(**TINY)
    tp = _port(tree, cfg)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, L, 128)).astype(np.float32)
    cond = rng.normal(0, 1, (2, 128)).astype(np.float32)
    mask = np.asarray(j_mask_for_config(jcfg))
    want = jtfm.blocks_forward(jp["blocks"], jnp.asarray(x), jnp.asarray(cond), jcfg,
                               jnp.asarray(mask))
    got = tfm.blocks_forward(tp["blocks"], torch.from_numpy(x), torch.from_numpy(cond),
                             cfg, torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_forward_train_logits_match_jax(weights):
    jp, tree, _, _ = weights
    cfg = ControlVARConfig(**TINY)
    tp = _port(tree, cfg)
    b, x = _tokens(1), _x_tf(1)
    want = JModel(JCfg(**TINY)).forward_train(
        jp, jnp.asarray(b["cls"]), jnp.asarray(x), jnp.asarray(b["type"]),
        train=False, compute_dtype=jnp.float32)
    got = ControlVARModel(cfg, device="cpu").forward_train(
        tp, torch.from_numpy(b["cls"]), torch.from_numpy(x), torch.from_numpy(b["type"]),
        train=False, compute_dtype=torch.float32)
    assert got.shape == (2, L, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)


def _labels(seed, B=2):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (B, L))


def _port_grads(tree, b, x, remat, drop_path_rate=0.0, seed=None):
    """CE gradients of the training forward; remat=False replaces the
    per-layer checkpoint with a plain call of the layer."""
    cfg = ControlVARConfig(**TINY, drop_path_rate=drop_path_rate)
    tp = _port(tree, cfg)
    for _, leaf in named_leaves(tp):
        leaf.requires_grad_(True)
    labels = torch.from_numpy(_labels(len(x), len(x)))
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    patch = (mock.patch.object(tfm, "checkpoint", wraps=tfm.checkpoint) if remat else
             mock.patch.object(tfm, "checkpoint", side_effect=lambda fn, *a, **kw: fn(*a)))
    with patch as ckpt:
        logits = ControlVARModel(cfg, device="cpu").forward_train(
            tp, torch.from_numpy(b["cls"]), torch.from_numpy(x), torch.from_numpy(b["type"]),
            generator=gen, train=True, compute_dtype=torch.float32)
        torch.log_softmax(logits, -1).gather(-1, labels[..., None]).mean().neg().backward()
    assert ckpt.call_count == cfg.depth
    return {name: leaf.grad.numpy() for name, leaf in named_leaves(tp)}


def test_grads_match_jax_with_and_without_remat(weights):
    jp, tree, _, _ = weights
    b, x = _tokens(2), _x_tf(2)
    labels = _labels(len(x), len(x))
    jm = JModel(JCfg(**TINY))

    def loss(p):
        logits = jm.forward_train(p, jnp.asarray(b["cls"]), jnp.asarray(x),
                                  jnp.asarray(b["type"]), train=True,
                                  compute_dtype=jnp.float32)
        return j_masked_ce(logits, jnp.asarray(labels), None)

    want = _leaf_dict(jax.grad(loss)(jp))
    with_remat = _port_grads(tree, b, x, remat=True)
    without = _port_grads(tree, b, x, remat=False)
    _assert_grads_close(with_remat, want)
    _assert_grads_close(without, want)
    for name in want:  # recompute changes what is saved, not the arithmetic
        np.testing.assert_array_equal(with_remat[name], without[name], err_msg=name)


def test_remat_with_drop_path_keeps_the_drawn_masks(weights):
    """Drop path under recompute: the same generator seed gives the same
    gradients with and without remat, and they differ from no drop path."""
    _, tree, _, _ = weights
    b, x = _tokens(3, B=8), _x_tf(3, B=8)
    with_remat = _port_grads(tree, b, x, remat=True, drop_path_rate=0.6, seed=5)
    without = _port_grads(tree, b, x, remat=False, drop_path_rate=0.6, seed=5)
    no_drop = _port_grads(tree, b, x, remat=False)
    for name in with_remat:
        np.testing.assert_array_equal(with_remat[name], without[name], err_msg=name)
    assert not np.allclose(with_remat["blocks/fc2/kernel"], no_drop["blocks/fc2/kernel"])


def test_forward_train_passes_the_models_tile_flags(weights, monkeypatch):
    """Every layer's attention gets the model's mask and the tile flags the
    model computed from it once, not flags made per call."""
    from controlvar_tpu_torch.ops.attention import tile_flags

    _, tree, _, _ = weights
    cfg = ControlVARConfig(**TINY)
    model = ControlVARModel(cfg, device="cpu")
    assert torch.equal(model._tile_flags, tile_flags(model._attn_mask))
    seen, flash_mha = [], tfm.flash_mha

    def spy(q, k, v, mask, scale, flags=None):
        seen.append((mask, flags))
        return flash_mha(q, k, v, mask, scale, flags)

    monkeypatch.setattr(tfm, "flash_mha", spy)
    b, x = _tokens(1), _x_tf(1)
    model.forward_train(_port(tree, cfg), torch.from_numpy(b["cls"]), torch.from_numpy(x),
                        torch.from_numpy(b["type"]), train=False, compute_dtype=torch.float32)
    assert len(seen) == cfg.depth
    assert all(m is model._attn_mask and f is model._tile_flags for m, f in seen)


@pytest.mark.parametrize("sched", ["cos", "lin", "lin0", "lin00", "lin0.3", "exp"])
def test_lr_wd_schedules_match_jax(sched):
    peak, wd, wd_end, wp_it, max_it = 3e-4, 0.05, 0.01, 10, 100
    for step in [0, 3, 9, 10, 11, 40, 70, 99]:
        lr, w = lr_schedule.lr_wd_at_step(sched, step, peak, wd, wd_end, wp_it, max_it)
        np.testing.assert_allclose(lr, float(jlr.lr_at_step(sched, step, peak, wp_it, max_it)),
                                   rtol=1e-5, err_msg=f"{sched}@{step}")
        np.testing.assert_allclose(w, float(jlr.wd_at_step(step, wd, wd_end, max_it)), rtol=1e-5)


def test_weight_decay_mask_matches_jax_leaf_for_leaf(weights):
    jp, tree, _, _ = weights
    cfg = ControlVARConfig(**TINY, cos_attn=True)
    tree = dict(tree, blocks=dict(tree["blocks"], scale_mul=np.zeros((2, 2), np.float32)))
    want = _leaf_dict(j_weight_decay_mask(tree))
    got = dict(named_leaves(weight_decay_mask(_port(tree, cfg))))
    assert got == want
    assert got["blocks/qkv_kernel"] and not got["blocks/scale_mul"]
    assert not got["blocks/fc1/bias"] and got["word_embed/kernel"]


def test_interleave_tokens_layout_matches_jax():
    rng = np.random.default_rng(4)
    pns = (1, 2, 4)
    c_ids = [rng.integers(0, 9, (2, p * p)) for p in pns]
    i_ids = [rng.integers(10, 19, (2, p * p)) for p in pns]
    c_h = [rng.normal(0, 1, (2, pns[k + 1] ** 2, 4)).astype(np.float32) for k in range(2)]
    i_h = [rng.normal(0, 1, (2, pns[k + 1] ** 2, 4)).astype(np.float32) for k in range(2)]
    t = lambda xs: [torch.from_numpy(a) for a in xs]
    j = lambda xs: [jnp.asarray(a) for a in xs]
    for mask_first in (True, False):
        labels, x_tf = interleave_tokens(t(c_ids), t(i_ids), t(c_h), t(i_h), mask_first)
        jl, jx = j_interleave_tokens(j(c_ids), j(i_ids), j(c_h), j(i_h), mask_first)
        np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(x_tf.numpy(), np.asarray(jx))
    labels, _ = interleave_tokens(t(c_ids), t(i_ids), t(c_h), t(i_h), True)
    assert labels.shape == (2, L)
    assert bool((labels[:, 2:6] < 10).all()) and bool((labels[:, 6:10] >= 10).all())


def _run_both(weights, batch_fn, from_tokens, j_step_cls, t_step_cls, n_steps=2):
    """n_steps of the JAX and the port's step from the same weights and
    batches; returns the per-step aux of each and the final params."""
    jp, tree, jvp, vtree = weights
    optim = dict(base_lr=1e-2, total_batch_size=512, grad_clip=1.0)
    jm = _JFp32Model(JCfg(**NO_DROP))
    jstep = j_step_cls(jm, JVQVAE(JVQCfg(**VQ)), JOptim(**optim), max_steps=100,
                       warmup_steps=1)
    jstate, tx = j_init_train_state(jp, JOptim(**optim))
    cfg = ControlVARConfig(**NO_DROP)
    tstep = t_step_cls(ControlVARModel(cfg, device="cpu"), VQVAE(VQVAEConfig(**VQ), device="cpu"),
                       OptimConfig(**optim), max_steps=100, warmup_steps=1, device="cpu")
    tstate = init_train_state(_port(tree, cfg), OptimConfig(**optim))
    tvp = _port(vtree, VQVAEConfig(**VQ))
    gen = torch.Generator().manual_seed(0)
    j_aux, t_aux = [], []
    for i in range(n_steps):
        batch = batch_fn(10 + i)
        jstate, ja = jstep.step(tx, jstate, jvp, _to_jax(batch), jax.random.key(i),
                                from_tokens=from_tokens)
        tstate, ta = tstep.step(tstate, tvp, _to_torch(batch), gen, from_tokens=from_tokens)
        j_aux.append(ja)
        t_aux.append(ta)
    return j_aux, t_aux, jstate.params, to_jax_params(tstate.params, cfg), tstate


def _assert_steps_close(j_aux, t_aux, j_params, t_params):
    for ja, ta in zip(j_aux, t_aux):
        np.testing.assert_allclose(float(ta["loss"]), float(ja["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(ta["grad_norm"]), float(ja["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(ta["lr"], float(ja["lr"]), rtol=1e-6)
        np.testing.assert_allclose(ta["wd"], float(ja["wd"]), rtol=1e-6)
        np.testing.assert_allclose(float(ta["acc"]), float(ja["acc"]), atol=1e-6)
    want = _leaf_dict(j_params)
    got = _leaf_dict(t_params)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], np.asarray(want[name]), atol=1e-5, rtol=0,
                                   err_msg=name)


def test_token_steps_match_jax(weights):
    """Two pre-tokenized steps (the second reads the first's AdamW moments);
    the clip is active (grad_norm > grad_clip = 1)."""
    j_aux, t_aux, jp, tp, state = _run_both(weights, _tokens, True, JTrainStep,
                                            _Fp32Step)
    _assert_steps_close(j_aux, t_aux, jp, tp)
    assert float(t_aux[0]["grad_norm"]) > 1.0 and state.step == 2
    moved = np.abs(tp["blocks"]["qkv_kernel"] - np.asarray(weights[1]["blocks"]["qkv_kernel"]))
    assert moved.max() > 1e-3  # a real update, well above the 1e-5 tolerance


def test_pixel_step_matches_jax_with_fp32_tokenizer(weights):
    j_aux, t_aux, jp, tp, _ = _run_both(weights, _pixels, False, _JFp32Step, _Fp32Step,
                                        n_steps=1)
    _assert_steps_close(j_aux, t_aux, jp, tp)


def test_grad_accum_matches_big_batch(weights):
    """accum=2 gives the single big batch's update, under an ignore mask
    whose weight is split unevenly between the microbatches."""
    _, tree, _, vtree = weights
    cfg = ControlVARConfig(**NO_DROP)
    optim = OptimConfig(base_lr=1e-3, total_batch_size=512)
    step = _Fp32Step(ControlVARModel(cfg, device="cpu"), VQVAE(VQVAEConfig(**VQ), device="cpu"),
                     optim, max_steps=100, warmup_steps=2, device="cpu")
    vp = _port(vtree, VQVAEConfig(**VQ))
    batch = _to_torch(_tokens(20, B=4))
    rng = np.random.default_rng(21)
    ign = rng.random((4, L)) < np.array([0.8, 0.8, 0.3, 0.3])[:, None]
    batch["ignore_mask"] = torch.from_numpy(ign.astype(np.float32))
    results = []
    for accum in (1, 2):
        state = init_train_state(_port(tree, cfg), optim)
        state, aux = step.step(state, vp, batch, from_tokens=True, accum=accum)
        results.append((aux, dict(named_leaves(state.params))))
    (a1, p1), (a2, p2) = results
    np.testing.assert_allclose(float(a2["loss"]), float(a1["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(a2["grad_norm"]), float(a1["grad_norm"]), rtol=1e-4)
    for name in p1:
        np.testing.assert_allclose(p2[name].detach().numpy(), p1[name].detach().numpy(),
                                   atol=2e-5, rtol=1e-4, err_msg=name)


def test_default_step_loss_decreases(weights):
    """Eight bf16 pixel steps (the defaults: bf16 tokenizer and residual
    stream, cond drop on) at lr 1e-2 on one batch."""
    _, tree, _, vtree = weights
    cfg = ControlVARConfig(**TINY)
    optim = OptimConfig(base_lr=1e-2, total_batch_size=512)
    step = ControlVARTrainStep(ControlVARModel(cfg, device="cpu"),
                               VQVAE(VQVAEConfig(**VQ), device="cpu"), optim,
                               max_steps=100, warmup_steps=2, device="cpu")
    state = init_train_state(_port(tree, cfg), optim)
    vp = _port(vtree, VQVAEConfig(**VQ))
    batch, gen = _to_torch(_pixels(30)), torch.Generator().manual_seed(1)
    losses = [float(step.step(state, vp, batch, gen)[1]["loss"]) for _ in range(8)]
    assert state.step == 8 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_drop_path_statistics():
    """Per-sample keep masks: a keep fraction of 1 - rate within 5 binomial
    standard deviations, factors exactly 0 or 1/keep, layer 0 never dropped."""
    rates = np.linspace(0.0, 0.3, 4, dtype=np.float32)
    n = 20000
    f = tfm._drop_path(torch.Generator().manual_seed(0), rates, n, torch.float32)
    assert f.shape == (4, 2, n)
    for li, rate in enumerate(rates):
        keep = 1.0 - float(rate)
        vals = f[li]
        assert bool(((vals == 0) | (vals == torch.tensor(1.0 / keep))).all())
        frac = float((vals > 0).float().mean())
        assert abs(frac - keep) <= 5 * np.sqrt(keep * (1 - keep) / (2 * n)) + 1e-9, (li, frac)
    assert bool((f[0] == 1).all())


def test_cond_drop_statistics(weights):
    """Class and cond-type drop at cond_drop_rate: the dropped share within
    5 binomial standard deviations; dropped rows take the unconditional ids."""
    _, tree, _, _ = weights
    cfg = ControlVARConfig(**TINY, cond_drop_rate=0.3)
    model = ControlVARModel(cfg, device="cpu")
    n = 20000
    labels = torch.full((n,), 3)
    cond_type = torch.full((n,), 1)
    new_labels, new_type = model._drop_cond(labels, cond_type, torch.Generator().manual_seed(2))
    assert set(new_labels.unique().tolist()) == {3, cfg.num_classes}
    assert set(new_type.unique().tolist()) == {1, 4}
    for dropped in ((new_labels == cfg.num_classes), (new_type == 4)):
        frac = float(dropped.float().mean())
        assert abs(frac - 0.3) <= 5 * np.sqrt(0.3 * 0.7 / n), frac
    # the two draws are independent
    both = float(((new_labels == cfg.num_classes) & (new_type == 4)).float().mean())
    assert abs(both - 0.09) <= 5 * np.sqrt(0.09 * 0.91 / n), both


def test_train_step_raises_without_cuda_and_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ControlVARConfig(**TINY)
    model = ControlVARModel(cfg, device="cpu")
    vqvae = VQVAE(VQVAEConfig(**VQ), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ControlVARTrainStep(model, vqvae, OptimConfig(), max_steps=10, warmup_steps=1)
    step = ControlVARTrainStep(model, vqvae, OptimConfig(), max_steps=10, warmup_steps=1,
                               device="cpu")
    assert step.device == torch.device("cpu")
