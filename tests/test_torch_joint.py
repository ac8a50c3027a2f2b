"""The port's joint (control, image) generation and the conditional
sampler's cache modes, against the JAX package.

Both sides run on the CPU in fp32 with the same weights (JAX init, carried
over by ckpt/convert.py). Greedy sampling (top_k=1) makes the draw
deterministic, so the per-scale sampled ids must be identical and the
canvases agree to fp32 reassociation noise (atol 1e-4), whichever cache
mode runs: stacked (K1's plain version), in place (K6's), or segmented with
and without a KV window (K1's at scale 0, K5's after). `more_smooth` draws
gumbel noise from each framework's own stream, so its cases replace
`gumbel_softmax` on both sides by the noise-free softmax at the same
temperature: they hold the wiring (logit factor, temperature, soft
embeddings), and tests/test_torch_sampling_sort.py holds the noise."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import controlvar_tpu.eval.stepwise as jax_stepwise
from controlvar_tpu.config import ControlVARConfig as JCfg, VQVAEConfig as JVQ
from controlvar_tpu.models.control_var import ControlVARModel as JModel
from controlvar_tpu.models.vqvae import VQVAE as JVQVAE

import controlvar_tpu_torch.eval.stepwise as torch_stepwise
from controlvar_tpu_torch.ckpt.convert import from_jax_params
from controlvar_tpu_torch.config import ControlVARConfig, SampleConfig, VQVAEConfig
from controlvar_tpu_torch.eval.harness import SamplingHarness
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.vqvae import VQVAE

# four scales, so that a window of one drops a middle segment at the last
PNS = (1, 2, 3, 4)
TINY_VQ = dict(ch=32, patch_nums=PNS, vocab_size=64)
TINY = dict(depth=2, embed_dim=128, num_heads=2, patch_nums=PNS, vocab_size=64, cvae=32,
            num_classes=8, mask_factor=2, multi_cond=True)
SOS_VARIANT = dict(multi_cond=False, bidirectional=True)


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def setup():
    jm, jv = JModel(JCfg(**TINY)), JVQVAE(JVQ(**TINY_VQ))
    jp, jvp = jm.init_params(jax.random.key(1)), jv.init_params(jax.random.key(0))
    cfg, vq_cfg = ControlVARConfig(**TINY), VQVAEConfig(**TINY_VQ)
    return dict(jm=jm, jv=jv, jp=jp, jvp=jvp,
                tm=ControlVARModel(cfg, device="cpu"), tv=VQVAE(vq_cfg, device="cpu"),
                tp=from_jax_params(_tree(jp), cfg, device="cpu"),
                tvp=from_jax_params(_tree(jvp), vq_cfg, device="cpu"),
                labels=np.array([1, 5]), ct=np.array([0, 2]))


def _with_sos_variant(s):
    """The class-embedding SOS of a model without multi_cond, under the
    bidirectional sign convention; the tokenizer is shared."""
    jcfg, cfg = JCfg(**{**TINY, **SOS_VARIANT}), ControlVARConfig(**{**TINY, **SOS_VARIANT})
    jm = JModel(jcfg)
    jp = jm.init_params(jax.random.key(2))
    return dict(s, jm=jm, jp=jp, tm=ControlVARModel(cfg, device="cpu"),
                tp=from_jax_params(_tree(jp), cfg, device="cpu"))


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


def _noise_free_smoothing(monkeypatch):
    monkeypatch.setattr(jax_stepwise, "gumbel_softmax",
                        lambda key, logits, tau, hard=False: jax.nn.softmax(
                            logits.astype(jnp.float32) / tau, axis=-1))
    monkeypatch.setattr(torch_stepwise, "gumbel_softmax",
                        lambda logits, tau, hard=False, generator=None: torch.softmax(
                            logits.float() / tau, dim=-1))


def _compare(jax_ids, torch_ids, jout, tout):
    assert len(jax_ids) == len(torch_ids) == len(PNS)
    for si, (a, b) in enumerate(zip(jax_ids, torch_ids)):
        np.testing.assert_array_equal(a, b, err_msg=f"scale {si}")
    for a, b in zip(jout, tout):
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4, rtol=0)


# case: (sampler arguments, decode the canvases; else compare the f_hats)
JOINT_CASES = {
    "stacked": (dict(cache_mode="stacked"), True),
    "inplace": (dict(cache_mode="stacked", inplace_decode=True), False),
    "seg-window1-image-first": (dict(cache_mode="seg", kv_window=1, mask_first=False), True),
    "seg-smooth": (dict(cache_mode="seg", more_smooth=True), False),
    "class-sos-bidirectional": (dict(cache_mode="stacked", mask_first=False), False),
}


@pytest.mark.parametrize("case", list(JOINT_CASES))
def test_joint_greedy_matches_jax(setup, monkeypatch, case):
    s = _with_sos_variant(setup) if case == "class-sos-bidirectional" else setup
    kw, decode = dict(JOINT_CASES[case][0]), JOINT_CASES[case][1]
    inplace = kw.pop("inplace_decode", False)
    if kw.get("more_smooth"):
        _noise_free_smoothing(monkeypatch)
    if inplace:
        monkeypatch.setenv("CONTROLVAR_INPLACE_DECODE", "1")
    jax_ids = _recorder(jax_stepwise, monkeypatch, traced=True)
    torch_ids = _recorder(torch_stepwise, monkeypatch)
    common = dict(cfg_scale=2.0, top_k=1, top_p=0.0, **kw)
    js = jax_stepwise.StepwiseJointSampler(s["jm"], s["jv"], **common)
    js.compute_dtype = jnp.float32
    jout = js(s["jp"], s["jvp"], jnp.asarray(s["labels"]), jnp.asarray(s["ct"]),
              jax.random.key(7), decode_img=decode)
    jax.block_until_ready(jout)
    ts = torch_stepwise.StepwiseJointSampler(s["tm"], s["tv"], inplace_decode=inplace,
                                             device="cpu", compute_dtype=torch.float32,
                                             **common)
    tout = ts(s["tp"], s["tvp"], torch.from_numpy(s["labels"]), torch.from_numpy(s["ct"]),
              torch.Generator().manual_seed(7), decode_img=decode)
    assert tout[0].shape == ((2, 64, 64, 3) if decode else (2, 4, 4, 32))
    _compare(jax_ids, torch_ids, jout, tout)


def test_kv_window_covering_equals_full_prefix_and_small_window_drops(setup, monkeypatch):
    """A window that covers every scale reads the full prefix: canvases
    bit-equal to the plain seg mode (compared as f_hats). A window of one
    drops the middle segment at the last scale."""
    s = setup
    calls = []
    orig = torch_stepwise._windowed_segs

    def spy(sk, sv, w):
        out = orig(sk, sv, w)
        calls.append((len(sk), len(out[0])))
        return out

    monkeypatch.setattr(torch_stepwise, "_windowed_segs", spy)

    def run(**kw):
        ts = torch_stepwise.StepwiseJointSampler(s["tm"], s["tv"], cfg_scale=2.0, top_k=10,
                                                 top_p=0.9, cache_mode="seg", device="cpu",
                                                 compute_dtype=torch.float32, **kw)
        return ts(s["tp"], s["tvp"], torch.from_numpy(s["labels"]),
                  torch.from_numpy(s["ct"]), torch.Generator().manual_seed(3),
                  decode_img=False)

    for a, b in zip(run(), run(kv_window=len(PNS))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    calls.clear()
    for t in run(kv_window=1):
        assert torch.isfinite(t).all()
    assert calls == [(0, 0), (1, 1), (2, 2), (3, 2)]


def test_cache_mode_guards(setup):
    s = setup
    m, v = s["tm"], s["tv"]
    with pytest.raises(ValueError, match="requires cache_mode='seg'"):
        torch_stepwise.StepwiseJointSampler(m, v, cache_mode="stacked", kv_window=2,
                                            device="cpu")
    with pytest.raises(ValueError, match="requires cache_mode='seg'"):
        torch_stepwise.StepwiseCondSampler(m, v, kv_window=2, device="cpu")
    with pytest.raises(ValueError, match="applies to cache_mode='stacked'"):
        torch_stepwise.StepwiseJointSampler(m, v, cache_mode="seg", inplace_decode=True,
                                            device="cpu")
    indep = ControlVARModel(ControlVARConfig(**TINY, separate_decoding=True, indep=True),
                            device="cpu")
    with pytest.raises(ValueError, match="indep"):
        torch_stepwise.StepwiseJointSampler(indep, v, cache_mode="seg", kv_window=1,
                                            device="cpu")
    # three heads of 64: the JAX package's flat layout, where seg becomes stacked
    flat = ControlVARModel(ControlVARConfig(**{**TINY, "embed_dim": 192, "num_heads": 3}),
                           device="cpu")
    assert torch_stepwise.StepwiseJointSampler(flat, v, cache_mode="seg",
                                               device="cpu").cache_mode == "stacked"
    assert torch_stepwise.StepwiseJointSampler(m, v, cache_mode="seg",
                                               device="cpu").cache_mode == "seg"


@pytest.mark.parametrize("force,kv_window,more_smooth", [("control", None, False),
                                                          ("image", 1, True)])
def test_cond_sampler_seg_matches_jax(setup, monkeypatch, force, kv_window, more_smooth):
    """StepwiseCondSampler in the segmented cache mode, with and without a
    KV window, and with more_smooth, against the JAX sampler."""
    s = setup
    if more_smooth:
        _noise_free_smoothing(monkeypatch)
    rng = np.random.default_rng(4)
    forced = [rng.integers(0, 64, (2, pn * pn)) for pn in PNS]
    kw = dict(cfg_scales=(2.0, 1.0, 0.5), top_k=1, top_p=0.0, force=force,
              cache_mode="seg", kv_window=kv_window, more_smooth=more_smooth)
    jax_ids = _recorder(jax_stepwise, monkeypatch, traced=True)
    torch_ids = _recorder(torch_stepwise, monkeypatch)
    js = jax_stepwise.StepwiseCondSampler(s["jm"], s["jv"], **kw)
    js.compute_dtype = jnp.float32
    jout = js(s["jp"], s["jvp"], jnp.asarray(s["labels"]), jnp.asarray(s["ct"]),
              jax.random.key(9), [jnp.asarray(f, jnp.int32) for f in forced],
              decode_img=force == "control")
    jax.block_until_ready(jout)
    ts = torch_stepwise.StepwiseCondSampler(s["tm"], s["tv"], device="cpu",
                                            compute_dtype=torch.float32, **kw)
    tout = ts(s["tp"], s["tvp"], torch.from_numpy(s["labels"]), torch.from_numpy(s["ct"]),
              torch.Generator().manual_seed(9), [torch.from_numpy(f) for f in forced],
              decode_img=force == "control")
    _compare(jax_ids, torch_ids, jout, tout)


def test_harness_joint_and_gibbs_refine_end_to_end(setup):
    """SamplingHarness.joint with a KV window (all three samplers in seg
    mode), then gibbs_refine over its canvases: the right shapes, finite
    canvases in [0, 1]; gibbs_refine refuses a harness that decodes only
    the generated canvas."""
    s = setup
    th = SamplingHarness(s["tm"], s["tv"], SampleConfig(top_k=10, top_p=0.9, kv_window=1),
                         compute_dtype=torch.float32, device="cpu")
    assert {x.cache_mode for x in (th._joint, th._cond_mask, th._cond_img)} == {"seg"}
    p = th.prepare_params(s["tp"])
    labels, ct = torch.from_numpy(s["labels"]), torch.from_numpy(s["ct"])

    g = torch.Generator().manual_seed(5)
    joint = th.joint(p, s["tvp"], labels, ct, g)
    for a in joint + th.gibbs_refine(p, s["tvp"], labels, ct, g, *joint):
        assert a.shape == (2, 64, 64, 3) and torch.isfinite(a).all()
        assert 0.0 <= float(a.min()) and float(a.max()) <= 1.0
    only = SamplingHarness(s["tm"], s["tv"], SampleConfig(), device="cpu",
                           decode_generated_only=True)
    with pytest.raises(ValueError, match="both canvases"):
        only.gibbs_refine(p, s["tvp"], labels, ct, torch.Generator(), *joint)
