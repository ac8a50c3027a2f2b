"""The port's LoRA (`ckpt/lora.py`) and LoRA fine-tune step against the JAX
package's, fp32 on the CPU, at the tiny ControlVAR config of
tests/test_torch_train_step.py: the JAX factors loaded into the port give
the same merged kernels, B = 0 leaves the logits as they were, and steps
of `LoRAControlVARTrainStep` from the same factors match the JAX step
while the base gets no gradient.

Tolerances: merged kernels to 1e-6 absolute (a rank-16 fp32 product added
to kernels of magnitude ~0.05); the step's loss to 1e-5 and grad_norm to
1e-4 relative, and the factors to 1e-5 absolute after the update, those of
tests/test_torch_train_step.py for the whole-model step."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlvar_tpu.ckpt import lora as jlora
from controlvar_tpu.config import ControlVARConfig as JCfg
from controlvar_tpu.config import OptimConfig as JOptim
from controlvar_tpu.config import VQVAEConfig as JVQCfg
from controlvar_tpu.models.control_var import ControlVARModel as JModel
from controlvar_tpu.models.vqvae import VQVAE as JVQVAE
from controlvar_tpu.train.train_step import ControlVARTrainStep as JTrainStep
from controlvar_tpu.train.train_step import LoRAControlVARTrainStep as JLoRAStep

from controlvar_tpu_torch.ckpt.convert import from_jax_params, to_jax_params
from controlvar_tpu_torch.ckpt.lora import (DEFAULT_TARGETS, LoRAConfig, apply_lora,
                                            init_lora_params, merge_lora)
from controlvar_tpu_torch.config import ControlVARConfig, OptimConfig, VQVAEConfig
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.train.param_groups import named_leaves
from controlvar_tpu_torch.train.train_step import ControlVARTrainStep, LoRAControlVARTrainStep

VQ = dict(ch=32, patch_nums=(1, 2, 4), vocab_size=128)
TINY = dict(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 4), vocab_size=128,
            cvae=32, num_classes=8, mask_factor=2, multi_cond=True, cond_drop_rate=0.0)
L = 42
OPTIM = dict(base_lr=1e-2, total_batch_size=512, grad_clip=1.0)


@dataclasses.dataclass(frozen=True)
class _JFp32Model(JModel):
    """The JAX model with an fp32 residual stream."""

    def forward_train(self, *args, **kwargs):
        return super().forward_train(*args, compute_dtype=jnp.float32, **kwargs)


class _Fp32Step(ControlVARTrainStep):
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
    """(numpy ControlVAR tree, JAX ControlVAR params, numpy VQVAE tree in the
    JAX layout, JAX LoRA factors with A from the JAX init and B random)."""
    cfg = ControlVARConfig(**TINY)
    tree = to_jax_params(ControlVARModel(cfg, device="cpu").init_params(1), cfg)
    vq = VQVAEConfig(**VQ)
    vtree = _vq_to_jax(VQVAE(vq, device="cpu").init_params(0))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jl = jlora.init_lora_params(jax.random.key(2), jp, jlora.LoRAConfig())
    rng = np.random.default_rng(3)
    jl = {k: {"A": ab["A"], "B": jnp.asarray(rng.normal(0, 0.05, ab["B"].shape), jnp.float32)}
          for k, ab in jl.items()}
    return tree, jp, vtree, jl


def _port_lora(jl):
    return {k: {n: torch.from_numpy(np.array(v)) for n, v in ab.items()} for k, ab in jl.items()}


def _leaves(tree):
    return dict(named_leaves(tree))


@pytest.mark.parametrize("fn", ["apply_lora", "merge_lora"])
def test_merged_kernels_match_jax(weights, fn):
    tree, jp, _, jl = weights
    cfg = ControlVARConfig(**TINY)
    port_fn = {"apply_lora": apply_lora, "merge_lora": merge_lora}[fn]
    got = port_fn(from_jax_params(tree, cfg, device="cpu"), _port_lora(jl), LoRAConfig())
    want = getattr(jlora, fn)(jp, jl, jlora.LoRAConfig())
    got, want = _leaves(got), _leaves(jax.tree_util.tree_map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w, atol=1e-6, rtol=0,
                                   err_msg=name)
        if name not in {"/".join(t) for t in DEFAULT_TARGETS}:
            assert np.array_equal(got[name].detach().numpy(), w), name
    moved = np.abs(want["blocks/fc1/kernel"] - tree["blocks"]["fc1"]["kernel"]).max()
    assert moved > 1e-2  # the deltas are real, far above the tolerance


def test_init_lora_params():
    """A kaiming-uniform within sqrt(6 / fan_in), B zero, one pair a target,
    per-layer factors for the stacked kernels, drawn from the generator."""
    cfg = ControlVARConfig(**TINY)
    params = ControlVARModel(cfg, device="cpu").init_params(1)
    lcfg = LoRAConfig(rank=4)
    lora = init_lora_params(torch.Generator().manual_seed(0), params, lcfg)
    assert sorted(lora) == sorted("/".join(t) for t in DEFAULT_TARGETS)
    assert lora["blocks/fc1/kernel"]["A"].shape == (2, 128, 4)
    assert lora["blocks/fc1/kernel"]["B"].shape == (2, 4, 512)
    assert lora["head_nm/ada_lin/kernel"]["A"].shape == (128, 4)
    for key, ab in lora.items():
        fan_in = ab["A"].shape[-2]
        bound = np.sqrt(6.0 / fan_in)
        assert float(ab["A"].abs().max()) <= bound and float(ab["A"].abs().max()) > 0.9 * bound
        assert not bool(ab["B"].any())
    again = init_lora_params(torch.Generator().manual_seed(0), params, lcfg)
    assert all(torch.equal(again[k]["A"], lora[k]["A"]) for k in lora)


def test_zero_b_leaves_the_logits_unchanged(weights):
    tree, _, _, _ = weights
    cfg = ControlVARConfig(**TINY)
    model = ControlVARModel(cfg, device="cpu")
    params = from_jax_params(tree, cfg, device="cpu")
    lora = init_lora_params(torch.Generator().manual_seed(0), params, LoRAConfig())
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0, 1, (2, L - 2, 32)).astype(np.float32))
    args = (torch.tensor([1, 2]), x, torch.tensor([0, 3]))
    base = model.forward_train(params, *args, train=False, compute_dtype=torch.float32)
    with_lora = model.forward_train(apply_lora(params, lora, LoRAConfig()), *args, train=False,
                                    compute_dtype=torch.float32)
    assert torch.equal(base, with_lora)


def _tokens(seed, B=2):
    rng = np.random.default_rng(seed)
    ids = lambda: [rng.integers(0, TINY["vocab_size"], (B, p * p)) for p in TINY["patch_nums"]]
    return dict(ctrl_ids=ids(), img_ids=ids(), cls=rng.integers(0, 8, (B,)),
                type=rng.integers(0, 4, (B,)))


def test_lora_steps_match_jax_and_leave_the_base_alone(weights):
    """Two pre-tokenized fp32 steps from the same factors (JAX's A, B = 0):
    the first moves A by its weight decay alone (B = 0 gives A no
    gradient), the second by its gradient too. The base leaves are set to
    require grad beforehand, as a whole-model train state leaves them: they
    still get no gradient and stay as they were, and grad_norm is the
    factors' alone."""
    tree, jp, vtree, _ = weights
    jcfg, cfg = JCfg(**TINY), ControlVARConfig(**TINY)
    jbase = JTrainStep(_JFp32Model(jcfg), JVQVAE(JVQCfg(**VQ)), JOptim(**OPTIM), max_steps=100,
                       warmup_steps=1)
    jstep = JLoRAStep(jbase, jlora.LoRAConfig())
    jstate, tx = jstep.init_lora_state(jax.random.key(7), jp, JOptim(**OPTIM))
    tbase = _Fp32Step(ControlVARModel(cfg, device="cpu"), VQVAE(VQVAEConfig(**VQ), device="cpu"),
                      OptimConfig(**OPTIM), max_steps=100, warmup_steps=1, device="cpu")
    tstep = LoRAControlVARTrainStep(tbase, LoRAConfig())
    base = from_jax_params(tree, cfg, device="cpu")
    for _, leaf in named_leaves(base):
        leaf.requires_grad_(True)
    before = {k: v.detach().clone() for k, v in named_leaves(base)}
    tstate = tstep.init_lora_state(torch.Generator().manual_seed(0), base, OptimConfig(**OPTIM))
    with torch.no_grad():
        for key, ab in tstate.params.items():
            ab["A"].copy_(torch.from_numpy(np.array(jstate.params[key]["A"])))
    opt = tstate.optimizer
    assert len(opt.param_groups) == 1 and len(opt.param_groups[0]["params"]) == 10
    jvp, tvp = jax.tree_util.tree_map(jnp.asarray, vtree), from_jax_params(
        vtree, VQVAEConfig(**VQ), device="cpu")
    for i in range(2):
        batch = _tokens(10 + i)
        jb = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a.astype(np.int32) if a.dtype.kind == "i" else a), batch)
        jstate, ja = jstep.step(tx, jstate, jp, jvp, jb, jax.random.key(i), from_tokens=True)
        tstate, ta = tstep.step(tstate, base, tvp, jax.tree_util.tree_map(torch.from_numpy, batch),
                                from_tokens=True)
        np.testing.assert_allclose(float(ta["loss"]), float(ja["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(ta["grad_norm"]), float(ja["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(ta["lr"], float(ja["lr"]), rtol=1e-6)
        np.testing.assert_allclose(ta["wd"], float(ja["wd"]), rtol=1e-6)
        want = _leaves(jax.tree_util.tree_map(np.asarray, jstate.params))
        got = _leaves(tstate.params)
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            np.testing.assert_allclose(got[name].detach().numpy(), w, atol=1e-5, rtol=0,
                                       err_msg=f"step {i}: {name}")
    assert float(tstate.params["blocks/fc2/kernel"]["B"].detach().abs().max()) > 1e-3
    assert tstate.step == 2
    for name, leaf in named_leaves(base):
        assert leaf.grad is None, name
        assert torch.equal(leaf.detach(), before[name]), name
