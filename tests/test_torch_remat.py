"""The remat policies of the port's training forward (`full`, `dots`,
`dots_attn`; `transformer.blocks_forward(remat=...)`) on the CPU: a policy
changes what the backward keeps, never the math, so gradients are bit for
bit those of `full`, under drop path too (the drawn masks are reused, not
redrawn). What each keeps shows in what the backward recomputes: `dots`
reruns no weight matmul (aten.mm), `dots_attn` neither those nor the
attention forward, so a step calls the attention forward (K3 on the card)
2 x depth times under `full` and `dots` and depth times under `dots_attn`.
Against the JAX package under CONTROLVAR_REMAT the gradients agree to 1e-4
of each leaf's largest (fp32 reassociation), as tests/test_transformer.py
holds the JAX policies to one another."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from controlvar_tpu.config import VARConfig as JCfg
from controlvar_tpu.models import transformer as jtfm
from controlvar_tpu.models.var import VARModel as JModel

from controlvar_tpu_torch.config import ControlVARConfig, OptimConfig, VARConfig, VQVAEConfig
from controlvar_tpu_torch.ckpt.convert import from_jax_params
from controlvar_tpu_torch.models import transformer as tfm
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.var import VARModel
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.ops import attention
from controlvar_tpu_torch.train.param_groups import named_leaves
from controlvar_tpu_torch.train.train_step import (ControlVARTrainStep, VARTrainStep,
                                                   init_train_state)

from tests.torch_fixtures import one_torch_thread  # noqa: F401

POLICIES = ("full", "dots", "dots_attn")
TINY = dict(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 4), vocab_size=128,
            cvae=32, num_classes=8)
VQ = dict(ch=32, patch_nums=(1, 2, 4), vocab_size=128)


class _CountOps(TorchDispatchMode):
    """Counts the aten ops dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def forward_calls(monkeypatch):
    """A list that counts the calls of the attention forward (K3 on the card)."""
    calls, real = [], attention.flash_attention

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(attention, "flash_attention", spy)
    return calls


def _control_var_grads(remat, forward_calls):
    """Gradients of a loss of the ControlVAR training forward under drop
    path (rate 0.6, drawn from a seeded generator) and cond drop, with the
    attention forward's calls and the aten.mm of the backward."""
    cfg = ControlVARConfig(**TINY, multi_cond=True, drop_path_rate=0.6, cond_drop_rate=0.3)
    model = ControlVARModel(cfg, device="cpu")
    params = model.init_params(1)
    for _, leaf in named_leaves(params):
        leaf.requires_grad_(True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (8, cfg.seq_len - 2, 32)).astype(np.float32))
    forward_calls.clear()
    logits = model.forward_train(params, torch.arange(8) % 8, x, torch.arange(8) % 4,
                                 generator=torch.Generator().manual_seed(5),
                                 compute_dtype=torch.float32, remat=remat)
    loss = torch.log_softmax(logits, -1)[..., 0].mean().neg()
    with _CountOps() as ops:
        loss.backward()
    return ({n: leaf.grad for n, leaf in named_leaves(params)}, len(forward_calls),
            ops.counts.get("aten.mm", 0))


def test_policies_give_full_s_gradients_bit_for_bit(forward_calls):
    results = {remat: _control_var_grads(remat, forward_calls) for remat in POLICIES}
    full, full_calls, full_mm = results["full"]
    depth = TINY["depth"]
    assert full_calls == 2 * depth  # each layer's forward, then its recompute
    for remat in ("dots", "dots_attn"):
        grads, calls, mm = results[remat]
        assert sorted(grads) == sorted(full)
        for name in full:
            assert torch.equal(grads[name], full[name]), (remat, name)
        # qkv, proj, fc1 and fc2 of every layer are not recomputed
        assert mm == full_mm - 4 * depth, (remat, mm, full_mm)
        assert calls == (depth if remat == "dots_attn" else 2 * depth), remat


def _jax_blocks_grads(remat, monkeypatch):
    """Gradients of sum(y^2) through the JAX package's blocks_forward under
    CONTROLVAR_REMAT (the config and mask of tests/test_transformer.py's
    remat test), and the port's under remat, from the same weights."""
    cfg = JCfg(depth=4, embed_dim=64, num_heads=2, patch_nums=(1, 2, 3), vocab_size=64,
               cvae=8, num_classes=10)
    params = jax.jit(JModel(cfg).init_params)(jax.random.key(0))
    rng = np.random.default_rng(0)
    B, L, C = 2, cfg.seq_len, cfg.embed_dim
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    cond = rng.standard_normal((B, C)).astype(np.float32)
    mask = np.tril(np.ones((L, L), bool))
    monkeypatch.setenv("CONTROLVAR_REMAT", remat)

    def loss(bp):
        y = jtfm.blocks_forward(bp, jnp.asarray(x), jnp.asarray(cond), cfg, jnp.asarray(mask),
                                train=True, use_flash=False)
        return jnp.sum(y.astype(jnp.float32) ** 2)

    want = jax.grad(loss)(params["blocks"])
    pcfg = VARConfig(depth=4, embed_dim=64, num_heads=2, patch_nums=(1, 2, 3), vocab_size=64,
                     cvae=8, num_classes=10)
    bp = from_jax_params(jax.tree_util.tree_map(np.asarray, params), pcfg,
                         device="cpu")["blocks"]
    for _, leaf in named_leaves(bp):
        leaf.requires_grad_(True)
    y = tfm.blocks_forward(bp, torch.from_numpy(x), torch.from_numpy(cond), pcfg,
                           torch.from_numpy(mask), train=True, remat=remat)
    (y.float() ** 2).sum().backward()
    return dict(named_leaves(jax.tree_util.tree_map(np.asarray, want))), {
        n: leaf.grad.numpy() for n, leaf in named_leaves(bp)}


@pytest.mark.parametrize("remat", POLICIES)
def test_policies_match_the_jax_policies(remat, monkeypatch):
    want, got = _jax_blocks_grads(remat, monkeypatch)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-12,
                                   err_msg=name)


def test_an_unknown_policy_raises():
    cfg = VARConfig(**TINY)
    bp = VARModel(cfg, device="cpu").init_params(0)["blocks"]
    x, cond = torch.zeros(1, cfg.seq_len, 128), torch.zeros(1, 128)
    mask = torch.ones(cfg.seq_len, cfg.seq_len, dtype=torch.bool)
    for train in (True, False):
        with pytest.raises(ValueError, match="remat"):
            tfm.blocks_forward(bp, x, cond, cfg, mask, train=train, remat="nope")


def _step_params(kind, remat, forward_calls):
    """Params after one fp32 step of the ControlVAR or the VAR train step
    with drop path and cond drop from a seeded generator; and the attention
    forward's calls in the step."""
    vqvae = VQVAE(VQVAEConfig(**VQ), device="cpu")
    vp = vqvae.init_params(0)
    optim = OptimConfig(base_lr=1e-2, total_batch_size=512)
    g = torch.Generator().manual_seed(3)
    img = lambda: torch.rand(2, 64, 64, 3, generator=g) * 2 - 1
    if kind == "control_var":
        cfg = ControlVARConfig(**TINY, multi_cond=True, drop_path_rate=0.5)
        model, cls = ControlVARModel(cfg, device="cpu"), ControlVARTrainStep
        batch = {"image": img(), "mask": img(), "cls": torch.tensor([1, 2]),
                 "type": torch.tensor([0, 3])}
    else:
        cfg = VARConfig(**TINY, drop_path_rate=0.5)
        model, cls = VARModel(cfg, device="cpu"), VARTrainStep
        batch = {"image": img(), "cls": torch.tensor([1, 2])}
    step = cls(model, vqvae, optim, max_steps=10, warmup_steps=1, device="cpu", remat=remat)
    step.tokenize_dtype = step.compute_dtype = torch.float32
    state = init_train_state(model.init_params(1), optim)
    forward_calls.clear()
    step.step(state, vp, batch, torch.Generator().manual_seed(4))
    return {n: leaf.detach() for n, leaf in named_leaves(state.params)}, len(forward_calls)


@pytest.mark.parametrize("kind", ["control_var", "var"])
def test_train_steps_take_the_policy(kind, forward_calls):
    full, full_calls = _step_params(kind, "full", forward_calls)
    assert full_calls == 2 * TINY["depth"]
    for remat in ("dots", "dots_attn"):
        params, calls = _step_params(kind, remat, forward_calls)
        assert calls == (TINY["depth"] if remat == "dots_attn" else 2 * TINY["depth"]), remat
        for name in full:
            assert torch.equal(params[name], full[name]), (kind, remat, name)
