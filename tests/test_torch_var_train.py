"""The port's plain-VAR training (`VARModel.forward_train`, `VARTrainStep`)
against the JAX package's on the same weights and numpy inputs, fp32 on the
CPU, at a tiny config (depth 2, hd 64, patch_nums (1, 2, 4), V 128): the
teacher-forced logits, two pixel steps with AdamW (the VQVAE tokenizing
inside the step), the model's own mask and tile flags reaching every
layer, and the class drop drawn from the generator, by its statistics.

Tolerances are those of tests/test_torch_train_step.py: logits to 1e-4
absolute; the loss to 1e-5 and grad_norm to 1e-4 relative; the updated
params to 1e-5 absolute."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlvar_tpu.config import OptimConfig as JOptim
from controlvar_tpu.config import VARConfig as JCfg
from controlvar_tpu.config import VQVAEConfig as JVQCfg
from controlvar_tpu.models.var import VARModel as JModel
from controlvar_tpu.models.vqvae import VQVAE as JVQVAE
from controlvar_tpu.train.train_step import VARTrainStep as JTrainStep
from controlvar_tpu.train.train_step import init_train_state as j_init_train_state

from controlvar_tpu_torch.ckpt.convert import from_jax_params, to_jax_params
from controlvar_tpu_torch.config import OptimConfig, VARConfig, VQVAEConfig
from controlvar_tpu_torch.models import transformer as tfm
from controlvar_tpu_torch.models.masks import block_causal_mask
from controlvar_tpu_torch.models.var import VARModel
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.ops.attention import tile_flags
from controlvar_tpu_torch.train.param_groups import named_leaves
from controlvar_tpu_torch.train.train_step import VARTrainStep, init_train_state

VQ = dict(ch=32, patch_nums=(1, 2, 4), vocab_size=128)
TINY = dict(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 4), vocab_size=128,
            cvae=32, num_classes=8, cond_drop_rate=0.0)
L = 21
OPTIM = dict(base_lr=1e-2, total_batch_size=512, grad_clip=1.0)


@dataclasses.dataclass(frozen=True)
class _JFp32Model(JModel):
    """The JAX model with an fp32 residual stream (its train step always
    takes the default bf16)."""

    def forward_train(self, *args, **kwargs):
        return super().forward_train(*args, compute_dtype=jnp.float32, **kwargs)


class _JFp32Step(JTrainStep):
    tokenize_dtype = jnp.float32


class _Fp32Step(VARTrainStep):
    tokenize_dtype = torch.float32
    compute_dtype = torch.float32


def _vq_to_jax(tree):
    """The port's VQVAE tree as numpy in the JAX layout (OIHW -> HWIO)."""
    if isinstance(tree, dict):
        return {k: (v.numpy().transpose(2, 3, 1, 0) if k == "kernel" else _vq_to_jax(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_vq_to_jax(v) for v in tree]
    return tree.numpy()


@pytest.fixture(scope="module")
def weights():
    """(numpy VAR tree, numpy VQVAE tree), both in the JAX layout."""
    cfg, vq = VARConfig(**TINY), VQVAEConfig(**VQ)
    return (to_jax_params(VARModel(cfg, device="cpu").init_params(1), cfg),
            _vq_to_jax(VQVAE(vq, device="cpu").init_params(0)))


def test_forward_train_logits_match_jax(weights):
    tree, _ = weights
    cfg = VARConfig(**TINY)
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 8, (3,))
    x = rng.normal(0, 1, (3, L - 1, 32)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    want = JModel(JCfg(**TINY)).forward_train(jp, jnp.asarray(labels), jnp.asarray(x),
                                               train=False, compute_dtype=jnp.float32)
    got = VARModel(cfg, device="cpu").forward_train(
        from_jax_params(tree, cfg, device="cpu"), torch.from_numpy(labels), torch.from_numpy(x),
        train=False, compute_dtype=torch.float32)
    assert got.shape == (3, L, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_forward_train_passes_the_models_mask_and_tile_flags(weights, monkeypatch):
    """Every layer's attention gets the block-causal mask and the tile
    flags the model computed from it once, not flags made per call."""
    tree, _ = weights
    cfg = VARConfig(**TINY)
    model = VARModel(cfg, device="cpu")
    assert np.array_equal(model._attn_mask.numpy(), block_causal_mask(cfg.patch_nums))
    assert torch.equal(model._tile_flags, tile_flags(model._attn_mask))
    seen, flash_mha = [], tfm.flash_mha

    def spy(q, k, v, mask, scale, flags=None):
        seen.append((mask, flags))
        return flash_mha(q, k, v, mask, scale, flags)

    monkeypatch.setattr(tfm, "flash_mha", spy)
    x = torch.zeros(2, L - 1, 32)
    model.forward_train(from_jax_params(tree, cfg, device="cpu"), torch.tensor([1, 2]), x,
                        generator=torch.Generator().manual_seed(0), compute_dtype=torch.float32)
    assert len(seen) == cfg.depth
    assert all(m is model._attn_mask and f is model._tile_flags for m, f in seen)


def _pixels(seed, B=2):
    rng = np.random.default_rng(seed)
    return dict(image=(rng.random((B, 64, 64, 3)) * 2 - 1).astype(np.float32),
                cls=rng.integers(0, 8, (B,)))


def test_two_pixel_steps_match_jax(weights):
    """Two fp32 steps (the second reads the first's AdamW moments), the
    fp32 tokenizer on both sides; the clip is active (grad_norm > 1)."""
    tree, vtree = weights
    cfg = VARConfig(**TINY)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jstep = _JFp32Step(_JFp32Model(JCfg(**TINY)), JVQVAE(JVQCfg(**VQ)), JOptim(**OPTIM),
                       max_steps=100, warmup_steps=1)
    jstate, tx = j_init_train_state(jp, JOptim(**OPTIM))
    tstep = _Fp32Step(VARModel(cfg, device="cpu"), VQVAE(VQVAEConfig(**VQ), device="cpu"),
                      OptimConfig(**OPTIM), max_steps=100, warmup_steps=1, device="cpu")
    tstate = init_train_state(from_jax_params(tree, cfg, device="cpu"), OptimConfig(**OPTIM))
    jvp = jax.tree_util.tree_map(jnp.asarray, vtree)
    tvp = from_jax_params(vtree, VQVAEConfig(**VQ), device="cpu")
    gen = torch.Generator().manual_seed(0)
    for i in range(2):
        batch = _pixels(20 + i)
        jb = {"image": jnp.asarray(batch["image"]), "cls": jnp.asarray(batch["cls"], jnp.int32)}
        jstate, ja = jstep.step(tx, jstate, jvp, jb, jax.random.key(i))
        tstate, ta = tstep.step(tstate, tvp, {k: torch.from_numpy(v) for k, v in batch.items()},
                                gen)
        np.testing.assert_allclose(float(ta["loss"]), float(ja["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(ta["grad_norm"]), float(ja["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(ta["lr"], float(ja["lr"]), rtol=1e-6)
        np.testing.assert_allclose(ta["wd"], float(ja["wd"]), rtol=1e-6)
        np.testing.assert_allclose(float(ta["acc"]), float(ja["acc"]), atol=1e-6)
        if i == 0:
            assert float(ta["grad_norm"]) > 1.0
    want = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jstate.params)))
    got = dict(named_leaves(to_jax_params(tstate.params, cfg)))
    assert sorted(got) == sorted(want) and tstate.step == 2
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=1e-5, rtol=0, err_msg=name)
    moved = np.abs(got["blocks/qkv_kernel"] - tree["blocks"]["qkv_kernel"]).max()
    assert moved > 1e-3  # a real update, well above the tolerance


def test_class_drop_statistics():
    """Each class id becomes the unconditional id num_classes at
    cond_drop_rate, within 5 binomial standard deviations, and the draw
    comes from the generator."""
    model = VARModel(VARConfig(**dict(TINY, cond_drop_rate=0.3)), device="cpu")
    n = 20000
    out = model._drop_class(torch.full((n,), 3), torch.Generator().manual_seed(2))
    assert set(out.unique().tolist()) == {3, 8}
    frac = float((out == 8).float().mean())
    assert abs(frac - 0.3) <= 5 * np.sqrt(0.3 * 0.7 / n), frac
    again = model._drop_class(torch.full((n,), 3), torch.Generator().manual_seed(2))
    assert torch.equal(out, again)
