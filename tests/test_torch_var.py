"""The port's plain VAR (class-conditional generation) against the JAX
package: the parameter conversion, the class embedder, and
`StepwiseVARSampler` in every cache mode and layout.

Both sides run on the CPU in fp32 with the same weights (the port's init,
carried to the JAX side by `to_jax_params`). Greedy sampling (top_k=1)
makes the draw deterministic, so the per-scale sampled ids must be
identical and the canvases agree to fp32 reassociation noise (atol 1e-4),
whichever attention runs: K1's plain version (stacked), K6's (in place),
K8's (fused), K7's (the flat layout of three heads of 64 and of hd 32), or
K1's and K5's (segmented, with and without a KV window). The config is the
tiny VAR of tests/test_stepwise.py with four scales, so that a window of
one drops a middle segment at the last scale."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import controlvar_tpu.eval.stepwise as jax_stepwise
from controlvar_tpu.config import VARConfig as JCfg, VQVAEConfig as JVQ
from controlvar_tpu.models import class_embedder as j_class_embedder
from controlvar_tpu.models.var import VARModel as JVAR
from controlvar_tpu.models.vqvae import VQVAE as JVQVAE

import controlvar_tpu_torch.eval.stepwise as torch_stepwise
from controlvar_tpu_torch.ckpt.convert import from_jax_params, to_jax_params
from controlvar_tpu_torch.config import ControlVARConfig, VARConfig, VQVAEConfig
from controlvar_tpu_torch.models import class_embedder
from controlvar_tpu_torch.models.var import VARModel
from controlvar_tpu_torch.models.vqvae import VQVAE

from tests.torch_fixtures import one_torch_thread, raise_gates, vq_to_jax  # noqa: F401

PNS = (1, 2, 3, 4)
TINY_VQ = dict(ch=32, patch_nums=PNS, vocab_size=64)
TINY = dict(depth=2, embed_dim=128, num_heads=2, patch_nums=PNS, vocab_size=64, cvae=32,
            num_classes=8)
# the flat layout: three heads of 64 (as tests/test_transformer.py) and hd 32
FLAT = {"flat-odd-heads": dict(depth=3, embed_dim=192, num_heads=3),
        "flat-hd32": dict(embed_dim=128, num_heads=4)}


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _models(cfg_kw, seed=1):
    """(JAX model, port model, JAX params, port params) of one config."""
    cfg = VARConfig(**cfg_kw)
    tm = VARModel(cfg, device="cpu")
    tp = raise_gates(tm.init_params(seed))
    return JVAR(JCfg(**cfg_kw)), tm, jax.tree_util.tree_map(jnp.asarray, to_jax_params(tp, cfg)), tp


@pytest.fixture(scope="module")
def vq():
    """The port's VQVAE init carried to the JAX side (the JAX init takes ~20 s
    here)."""
    tv = VQVAE(VQVAEConfig(**TINY_VQ), device="cpu")
    tvp = tv.init_params(0)
    return dict(jv=JVQVAE(JVQ(**TINY_VQ)),
                jvp=jax.tree_util.tree_map(jnp.asarray, vq_to_jax(tvp)), tv=tv, tvp=tvp)


def _recorder(module, monkeypatch, traced=False):
    """Record every draw of the sampler module; a traced (jitted) draw is
    recorded by a host callback when it runs."""
    calls = []
    orig = module.sample_top_k_top_p

    def spy(*args, **kw):
        out = orig(*args, **kw)
        if traced:
            jax.debug.callback(lambda x: calls.append(np.asarray(x)), out, ordered=True)
        else:
            calls.append(out.numpy())
        return out

    monkeypatch.setattr(module, "sample_top_k_top_p", spy)
    return calls


def test_var_params_round_trip_and_reject_other_trees():
    jm = JVAR(JCfg(**TINY))
    tree = _tree(jax.jit(jm.init_params)(jax.random.key(3)))
    cfg = VARConfig(**TINY)
    tp = from_jax_params(tree, cfg, device="cpu")
    back = to_jax_params(tp, cfg)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert tp["head"]["kernel"].shape == (128, 64)
    with pytest.raises(ValueError, match="not a VAR tree"):
        from_jax_params(tree, VARConfig(**{**TINY, "depth": 3}), device="cpu")
    with pytest.raises(ValueError, match="not a VAR tree"):   # ControlVAR-only keys
        from_jax_params(dict(tree, cond_embed=np.zeros((5, 128), np.float32)), cfg, device="cpu")
    with pytest.raises(ValueError, match="not a ControlVAR tree"):  # twice the sequence
        from_jax_params(tree, ControlVARConfig(**TINY, multi_cond=True), device="cpu")
    with pytest.raises(TypeError):
        to_jax_params(tp, VQVAEConfig())


def test_class_embedder_matches_jax():
    jp = j_class_embedder.init_params(jax.random.key(0), 10, 16)
    tp = {"embedding": torch.from_numpy(np.array(jp["embedding"]))}
    labels = np.array([0, 3, 9, 10, 3])
    want = j_class_embedder.apply(jp, jnp.asarray(labels), 10)
    got = class_embedder.apply(tp, torch.from_numpy(labels), 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    g = torch.Generator().manual_seed(0)
    t = torch.from_numpy(labels)
    torch.testing.assert_close(class_embedder.apply(tp, t, 10, 1.0, g, train=True),
                               tp["embedding"][[10] * 5], rtol=0, atol=0)
    torch.testing.assert_close(class_embedder.apply(tp, t, 10, 0.0, g, train=True), got,
                               rtol=0, atol=0)
    torch.testing.assert_close(class_embedder.apply(tp, t, 10, 1.0, None, train=True), got,
                               rtol=0, atol=0)
    # the port's init: 0.02 x a standard normal truncated at +-2
    e = class_embedder.init_params(torch.Generator().manual_seed(1), 1000, 64, device="cpu")
    e = e["embedding"]
    assert e.shape == (1001, 64) and float(e.abs().max()) <= 0.04
    assert abs(float(e.std()) - 0.02 * 0.8796) < 1e-3  # the truncated normal's std


# case: (config overrides, sampler arguments, JAX env switches, decode the images)
VAR_CASES = {
    "stacked": ({}, dict(cache_mode="stacked"), {}, True),
    "seg": ({}, dict(cache_mode="seg"), {}, False),
    "seg-window1": ({}, dict(cache_mode="seg", kv_window=1), {}, False),
    "inplace": ({}, dict(inplace_decode=True), {"CONTROLVAR_INPLACE_DECODE": "1"}, False),
    "fused": ({}, dict(kv_fused=True), {"CONTROLVAR_KV_FUSED": "1"}, False),
    "flat-odd-heads": (FLAT["flat-odd-heads"], {}, {}, True),
    "flat-hd32": (FLAT["flat-hd32"], {}, {}, False),
}


@pytest.mark.parametrize("case", list(VAR_CASES))
def test_var_sampler_greedy_matches_jax(vq, monkeypatch, case):
    over, kw, env, decode = VAR_CASES[case]
    jm, tm, jp, tp = _models({**TINY, **over})
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jax_kw = {k: v for k, v in kw.items() if k in ("cache_mode", "kv_window")}
    jax_ids = _recorder(jax_stepwise, monkeypatch, traced=True)
    torch_ids = _recorder(torch_stepwise, monkeypatch)
    labels = np.array([2, 7])
    # one jit for all four scales: a quarter of the per-scale jits' compiles
    js = jax_stepwise.StepwiseVARSampler(jm, vq["jv"], cfg_scale=1.5, top_k=1, top_p=0.0,
                                         groups=(tuple(range(len(PNS))),), **jax_kw)
    js.compute_dtype = jnp.float32
    jout = js(jp, vq["jvp"], jnp.asarray(labels), jax.random.key(3), decode_img=decode)
    jax.block_until_ready(jout)
    ts = torch_stepwise.StepwiseVARSampler(tm, vq["tv"], cfg_scale=1.5, top_k=1, top_p=0.0,
                                           device="cpu", compute_dtype=torch.float32, **kw)
    tout = ts(tp, vq["tvp"], torch.from_numpy(labels), torch.Generator().manual_seed(3),
              decode_img=decode)
    assert tout.shape == ((2, 64, 64, 3) if decode else (2, 4, 4, 32))
    assert len(jax_ids) == len(torch_ids) == len(PNS)
    for si, (a, b) in enumerate(zip(jax_ids, torch_ids)):
        np.testing.assert_array_equal(a, b, err_msg=f"scale {si}")
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-4, rtol=0)


def test_sample_cfg_more_smooth_draws_follow_the_softmax(vq, monkeypatch):
    """VARModel.sample_cfg(more_smooth=True) runs end to end; at the first
    scale (logit factor 1) the argmax of each gumbel-softmax sample is a
    draw from the softmax of the CFG logits: 2048 rows of one class sit
    within twice the multinomial noise of it in total variation."""
    _, tm, _, tp = _models(TINY)
    g = torch.Generator().manual_seed(5)
    imgs = tm.sample_cfg(tp, vq["tv"], vq["tvp"], torch.tensor([1, 6]), g, top_k=10, top_p=0.9,
                         more_smooth=True, compute_dtype=torch.float32)
    assert imgs.shape == (2, 64, 64, 3) and torch.isfinite(imgs).all()
    assert 0.0 <= float(imgs.min()) and float(imgs.max()) <= 1.0

    seen = []
    orig = torch_stepwise.gumbel_softmax

    def spy(logits, tau, hard=False, generator=None):
        out = orig(logits, tau, hard, generator)
        seen.append((logits, out))
        return out

    monkeypatch.setattr(torch_stepwise, "gumbel_softmax", spy)
    n = 2048
    fh = tm.sample_cfg(tp, vq["tv"], vq["tvp"], torch.full((n,), 3), g, more_smooth=True,
                       decode_img=False, compute_dtype=torch.float32)
    assert fh.shape == (n, 4, 4, 32) and torch.isfinite(fh).all()
    logits, soft = seen[0]
    assert soft.shape == (n, 1, 64)
    row = logits[0, 0].double()
    assert torch.allclose(logits[:, 0], logits[:1, 0].expand(n, -1))  # one class, one row
    p = torch.softmax(row, dim=-1).numpy()
    freq = np.bincount(soft[:, 0].argmax(-1).numpy(), minlength=64) / n
    tv = 0.5 * np.abs(freq - p).sum()
    noise = 0.5 * np.sqrt(p * (1 - p) / n).sum()
    assert tv < 2 * noise + 1e-3, (tv, noise)


def test_kv_fused_guards(vq):
    """Where the JAX package ignores CONTROLVAR_KV_FUSED=1, `kv_fused`
    raises: with the segmented mode, with in-place decode, on a flat layout.
    On a paired config it makes the fused cache."""
    _, tm, _, _ = _models(TINY)
    flat = VARModel(VARConfig(**{**TINY, **FLAT["flat-odd-heads"]}), device="cpu")
    sampler = lambda m, **kw: torch_stepwise.StepwiseVARSampler(m, vq["tv"], device="cpu",
                                                                kv_fused=True, **kw)
    with pytest.raises(ValueError, match="kv_fused applies to cache_mode='stacked'"):
        sampler(tm, cache_mode="seg")
    with pytest.raises(ValueError, match="without inplace_decode"):
        sampler(tm, inplace_decode=True)
    with pytest.raises(ValueError, match="kv_fused needs the paired KV layout"):
        sampler(flat)
    with pytest.raises(ValueError, match="inplace_decode needs the paired KV layout"):
        torch_stepwise.StepwiseVARSampler(flat, vq["tv"], device="cpu", inplace_decode=True)
    k, v = sampler(tm)._init_caches(4)
    assert k.shape == (2, 4, 2, 30, 128) and v.numel() == 0
    # the seg mode of a flat layout quietly becomes the stacked mode, as in the JAX package
    seg = torch_stepwise.StepwiseVARSampler(flat, vq["tv"], device="cpu", cache_mode="seg")
    k, v = seg._init_caches(4)
    assert seg.cache_mode == "stacked" and k.shape == v.shape == (3, 4, 3, 64, 32)
