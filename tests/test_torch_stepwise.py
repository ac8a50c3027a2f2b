"""The port's conditional generation as a whole, against the JAX package.

Both harnesses run on the CPU in fp32 with the same weights (JAX init,
carried over by ckpt/convert.py) and the same images. Greedy sampling
(top_k=1) makes the draw deterministic, so the per-scale sampled ids must be
identical and the canvases agree to fp32 reassociation noise (atol 1e-4).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import controlvar_tpu.eval.stepwise as jax_stepwise
from controlvar_tpu.config import ControlVARConfig as JCfg, SampleConfig as JSample
from controlvar_tpu.config import VQVAEConfig as JVQ
from controlvar_tpu.eval.harness import SamplingHarness as JHarness
from controlvar_tpu.models.control_var import ControlVARModel as JModel
from controlvar_tpu.models.vqvae import VQVAE as JVQVAE

import controlvar_tpu_torch.eval.stepwise as torch_stepwise
from controlvar_tpu_torch.ckpt.convert import from_jax_params
from controlvar_tpu_torch.config import ControlVARConfig, SampleConfig, VQVAEConfig
from controlvar_tpu_torch.eval.harness import SamplingHarness
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.vqvae import VQVAE

TINY_VQ = dict(ch=32, patch_nums=(1, 2, 4), vocab_size=64)
TINY = dict(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 4),
            vocab_size=64, cvae=32, num_classes=8, mask_factor=2, multi_cond=True)


@pytest.fixture(scope="module")
def setup():
    jm, jv = JModel(JCfg(**TINY)), JVQVAE(JVQ(**TINY_VQ))
    jp = jm.init_params(jax.random.key(1))
    jvp = jv.init_params(jax.random.key(0))
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    cfg, vq_cfg = ControlVARConfig(**TINY), VQVAEConfig(**TINY_VQ)
    tm, tv = ControlVARModel(cfg, device="cpu"), VQVAE(vq_cfg, device="cpu")
    tp = from_jax_params(tree(jp), cfg, device="cpu")
    tvp = from_jax_params(tree(jvp), vq_cfg, device="cpu")
    rng = np.random.default_rng(0)
    imgs = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    return dict(jm=jm, jv=jv, jp=jp, jvp=jvp, tm=tm, tv=tv, tp=tp, tvp=tvp,
                imgs=imgs, labels=np.array([1, 5]), ct=np.array([0, 2]))


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


@pytest.mark.parametrize("mode", ["control_conditioned", "image_conditioned"])
def test_greedy_generation_matches_jax(setup, monkeypatch, mode):
    s = setup
    sc = dict(cfg=(2.0, 2.0, 2.0), top_k=1, top_p=0.0)
    monkeypatch.setattr(JHarness, "compute_dtype", jnp.float32)
    jax_ids = _recorder(jax_stepwise, monkeypatch, traced=True)
    torch_ids = _recorder(torch_stepwise, monkeypatch)

    jh = JHarness(s["jm"], s["jv"], JSample(**sc))
    jc, ji = getattr(jh, mode)(
        jh.prepare_params(s["jp"]), s["jvp"], jnp.asarray(s["labels"]),
        jnp.asarray(s["ct"]), jax.random.key(9), jnp.asarray(s["imgs"]))
    jax.block_until_ready((jc, ji))
    th = SamplingHarness(s["tm"], s["tv"], SampleConfig(**sc),
                         compute_dtype=torch.float32, device="cpu")
    tc, ti = getattr(th, mode)(
        th.prepare_params(s["tp"]), s["tvp"], torch.from_numpy(s["labels"]),
        torch.from_numpy(s["ct"]), torch.Generator().manual_seed(9),
        torch.from_numpy(s["imgs"]))

    assert len(jax_ids) == len(torch_ids) == 3
    for si, (a, b) in enumerate(zip(jax_ids, torch_ids)):
        np.testing.assert_array_equal(a, b, err_msg=f"scale {si}")
    for a, b in ((jc, tc), (ji, ti)):
        assert b.shape == (2, 64, 64, 3)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4, rtol=0)


def test_seeded_top_k_top_p_generation_is_deterministic(setup):
    """Stochastic draws: the right shapes, finite canvases in [0, 1], the
    same canvases from the same seed and other ones from another seed."""
    s = setup
    th = SamplingHarness(s["tm"], s["tv"], SampleConfig(top_k=10, top_p=0.9),
                         compute_dtype=torch.float32, device="cpu")
    p = th.prepare_params(s["tp"])
    run = lambda seed: th.control_conditioned(
        p, s["tvp"], torch.from_numpy(s["labels"]), torch.from_numpy(s["ct"]),
        torch.Generator().manual_seed(seed), torch.from_numpy(s["imgs"]))
    (c1, i1), (c2, i2), (_, i3) = run(3), run(3), run(4)
    for t in (c1, i1):
        assert t.shape == (2, 64, 64, 3) and torch.isfinite(t).all()
        assert 0.0 <= float(t.min()) and float(t.max()) <= 1.0
    torch.testing.assert_close(c1, c2, rtol=0, atol=0)
    torch.testing.assert_close(i1, i2, rtol=0, atol=0)
    assert not torch.equal(i1, i3)


@pytest.mark.parametrize("force,repeat_num,decode", [("image", 3, "control"),
                                                     ("control", 4, "image")])
def test_greedy_sampler_variants_match_jax(setup, monkeypatch, force, repeat_num, decode):
    """StepwiseCondSampler directly, with random forced ids: the other force,
    3-way CFG and the single-canvas epilogues against the JAX sampler."""
    s = setup
    rng = np.random.default_rng(4)
    forced = [rng.integers(0, 64, (2, pn * pn)) for pn in TINY["patch_nums"]]
    kw = dict(cfg_scales=(2.0, 1.0, 0.5), top_k=1, top_p=0.0, force=force,
              repeat_num=repeat_num, decode=decode)
    jax_ids = _recorder(jax_stepwise, monkeypatch, traced=True)
    torch_ids = _recorder(torch_stepwise, monkeypatch)
    js = jax_stepwise.StepwiseCondSampler(s["jm"], s["jv"], **kw)
    js.compute_dtype = jnp.float32
    jout = js(s["jp"], s["jvp"], jnp.asarray(s["labels"]), jnp.asarray(s["ct"]),
              jax.random.key(9), [jnp.asarray(f, jnp.int32) for f in forced])
    jax.block_until_ready(jout)
    ts = torch_stepwise.StepwiseCondSampler(s["tm"], s["tv"], device="cpu",
                                            compute_dtype=torch.float32, **kw)
    tout = ts(s["tp"], s["tvp"], torch.from_numpy(s["labels"]), torch.from_numpy(s["ct"]),
              torch.Generator().manual_seed(9), [torch.from_numpy(f) for f in forced])
    for si, (a, b) in enumerate(zip(jax_ids, torch_ids)):
        np.testing.assert_array_equal(a, b, err_msg=f"scale {si}")
    assert len(torch_ids) == 3
    for a, b in zip(jout, tout):  # one decoded canvas and one raw f_hat
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4, rtol=0)
