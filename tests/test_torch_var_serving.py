"""Plain VAR served through `SamplingHarness.class_conditional`, held against
the benchmark's plain fp32 reference (`cvbench/reference/var.py`) at a tiny
size on the CPU: depth 2, two heads of 64, shared AdaLN, cosine attention,
a five-scale pyramid that is not the 256 default, 10 classes, V 64, the
gates raised in the shared_ada_lin bias (`cvbench/weights_var.py`), so
that attention moves every output.

The program runs in fp32 (no kernel on the CPU: K1's and K2's plain
versions). Its greedy draws must be the reference's argmax bit for bit; its
CFG-combined logits, recorded where the sampler draws, agree with the
reference's full teacher-forced forward over the same token stream to fp32
reassociation noise (atol 2e-5; the logits here are below 1 and agree to
~1e-6); its images with the reference's decode of the same ids to 1e-4
(the VQVAE tests' tolerance). Dropping each block's ada_gss, the shared modulation or
the CFG ramp moves the logits by 0.15 or more. `VARModel.sample_cfg`
is the same call, bit for bit, and the call opens the conditional call's
spans."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import controlvar_tpu_torch.models.transformer as tfm
from controlvar_tpu_torch.config import ControlVARConfig, SampleConfig, VARConfig, VQVAEConfig
from controlvar_tpu_torch.eval.harness import SamplingHarness
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.var import VARModel
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.utils import tracker

from cvbench import weights as W
from cvbench import weights_var as WV
from cvbench.reference import var as rv
from cvbench.reference import vqvae as vq
from cvbench.reference.prec import Prec, exact

from tests.torch_fixtures import one_torch_thread  # noqa: F401

PNS = [1, 2, 3, 4, 6]
M = dict(depth=2, embed_dim=128, num_heads=2, mlp_ratio=4.0, num_classes=10, vocab_size=64,
         cvae=32, patch_nums=PNS, cos_attn=True, shared_aln=True, drop_path_rate=0.0,
         cond_drop_rate=0.1, norm_eps=1e-6, tau=4.0, aln_gamma_init=1e-3)
V = dict(vocab_size=64, z_channels=32, ch=32, ch_mult=[1, 1, 2, 2, 4], num_res_blocks=2,
         quant_conv_ks=3, quant_resi=0.5, share_quant_resi=4, patch_nums=PNS, image_size=96)
CFG = dict(model=M, vqvae=V, init={"shared_gate_bias": [10.0, 1.0]})
GUIDANCE = 1.5
LABELS = torch.tensor([3, 7])
LOGIT_ATOL, IMAGE_ATOL = 2e-5, 1e-4


@pytest.fixture(scope="module")
def tiny():
    mc, vc = WV.model_configs(CFG)
    assert isinstance(mc, VARConfig) and isinstance(vc, VQVAEConfig)
    model, vqvae = VARModel(mc, device="cpu"), VQVAE(vc, device="cpu")
    return dict(model=model, vqvae=vqvae, P=WV.var_params(M, CFG["init"], 3, "cpu"),
                VQ=W.vqvae_params(V, 4, "cpu"))


def _harness(t, top_k=1, top_p=0.0):
    return SamplingHarness(t["model"], t["vqvae"],
                           SampleConfig(cfg=(GUIDANCE,) * 3, top_k=top_k, top_p=top_p),
                           compute_dtype=torch.float32, device="cpu")


def _served(t, harness, seed=5):
    """(images, [(combined logits, ids)] a scale) of one call."""
    seen = []
    draw = harness._var._draw

    def recorded(logits, generator):
        ids = draw(logits, generator)
        seen.append((logits, ids))
        return ids

    harness._var._draw = recorded
    params = harness.prepare_params(t["P"])
    img = harness.class_conditional(params, t["VQ"], LABELS, torch.Generator().manual_seed(seed))
    return img, seen


def _reference(t, seen):
    """Per image: the reference's combined logits a scale over the served
    stream, and its decode of the served ids in [0, 1]."""
    out = []
    with torch.no_grad(), exact():
        for b in range(LABELS.shape[0]):
            ids = [i[b: b + 1] for _, i in seen]
            x_tf = rv.teacher_features(vq.teacher_inputs(t["VQ"], ids, V))
            labels, x = rv.branch_inputs(LABELS[b: b + 1], x_tf, M["num_classes"])
            logits = rv.forward(t["P"], M, labels, x, Prec())
            combined = [rv.combined(logits, M, GUIDANCE, si) for si in range(len(PNS))]
            f_hat = vq.fhat_from_ids(t["VQ"], ids, V)
            out.append((combined, (vq.decode(t["VQ"], f_hat, V, Prec()) + 1) * 0.5))
    return out


def _gaps(t, harness):
    """The widest logit gap, whether every greedy id is the reference's
    argmax, and the widest image gap."""
    img, seen = _served(t, harness)
    assert img.shape == (2, 96, 96, 3) and len(seen) == len(PNS)
    logit_gap, same_ids, image_gap = 0.0, True, 0.0
    for b, (combined, want_img) in enumerate(_reference(t, seen)):
        for si, (logits, ids) in enumerate(seen):
            assert logits.shape == (2, PNS[si] ** 2, M["vocab_size"])
            logit_gap = max(logit_gap, float((logits[b] - combined[si]).abs().max()))
            same_ids &= torch.equal(ids[b], combined[si].argmax(dim=-1))
        image_gap = max(image_gap, float((img[b] - want_img[0]).abs().max()))
    return logit_gap, same_ids, image_gap


def test_class_conditional_matches_the_reference(tiny):
    logit_gap, same_ids, image_gap = _gaps(tiny, _harness(tiny))
    assert same_ids
    assert logit_gap < LOGIT_ATOL, logit_gap
    assert image_gap < IMAGE_ATOL, image_gap


def _no_ada_gss(orig):
    def ada(bp, cond, cfg, shared_lin=None, tp=None):
        return orig(dict(bp, ada_gss=torch.zeros_like(bp["ada_gss"])), cond, cfg, shared_lin, tp)
    return ada


def _no_shared_lin(orig):
    def ada(bp, cond, cfg, shared_lin=None, tp=None):
        zero = {k: torch.zeros_like(v) for k, v in shared_lin.items()}
        return orig(bp, cond, cfg, zero, tp)
    return ada


def _no_ramp(orig):
    def head(p, x, cond, cfg, weights, tp=None):    # the full guidance at every scale
        return orig(p, x, cond, cfg, (1.0 + GUIDANCE, -GUIDANCE), tp)
    return head


@pytest.mark.parametrize("mutation,target,make", [
    ("ada_gss dropped", "_ada_all_layers", _no_ada_gss),
    ("shared_ada_lin dropped", "_ada_all_layers", _no_shared_lin),
    ("CFG ramp removed", "head_logits_cfg", _no_ramp)])
def test_each_mutation_fails_the_comparison(tiny, monkeypatch, mutation, target, make):
    monkeypatch.setattr(tfm, target, make(getattr(tfm, target)))
    logit_gap, same_ids, _ = _gaps(tiny, _harness(tiny))
    assert logit_gap > 100 * LOGIT_ATOL, (mutation, logit_gap)


def test_sample_cfg_is_class_conditional_bit_for_bit(tiny):
    """The same generator seed through VARModel.sample_cfg (unprepared
    params) and through a harness (prepared, fp32: the same values): the
    same bits, sampled and as f_hat."""
    t = tiny
    harness = _harness(t, top_k=8, top_p=0.9)
    params = harness.prepare_params(t["P"])
    for decode in (True, False):
        got = harness.class_conditional(params, t["VQ"], LABELS,
                                        torch.Generator().manual_seed(11), decode_img=decode)
        want = t["model"].sample_cfg(t["P"], t["vqvae"], t["VQ"], LABELS,
                                     torch.Generator().manual_seed(11), cfg_scale=GUIDANCE,
                                     top_k=8, top_p=0.9, decode_img=decode,
                                     compute_dtype=torch.float32)
        assert torch.equal(got, want)


def test_the_harness_builds_one_sampler_per_model_kind(tiny):
    harness = _harness(tiny)
    assert hasattr(harness, "_var")
    assert not any(hasattr(harness, n) for n in ("_joint", "_cond_mask", "_cond_img"))
    prepared = harness.prepare_params(tiny["P"])
    assert prepared["blocks"]["ada_gss"].dtype == torch.float32
    bf16 = SamplingHarness(tiny["model"], tiny["vqvae"], device="cpu")
    assert bf16.prepare_params(tiny["P"])["blocks"]["ada_gss"].dtype == torch.bfloat16
    assert bf16.prepare_params(tiny["P"])["shared_ada_lin"]["bias"].dtype == torch.float32
    cv = ControlVARModel(ControlVARConfig(depth=2, embed_dim=128, num_heads=2, patch_nums=tuple(PNS),
                                          vocab_size=64, multi_cond=True), device="cpu")
    cv_harness = SamplingHarness(cv, tiny["vqvae"], device="cpu")
    assert not hasattr(cv_harness, "_var") and hasattr(cv_harness, "_cond_mask")
    with pytest.raises(TypeError, match="serves a VARModel"):
        cv_harness.class_conditional({}, tiny["VQ"], LABELS, torch.Generator())


def _spans(prof):
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith(tracker.SPAN_PREFIX)]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_class_conditional_call_spans(tiny):
    harness = _harness(tiny, top_k=8, top_p=0.9)
    params = harness.prepare_params(tiny["P"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        harness.class_conditional(params, tiny["VQ"], LABELS, torch.Generator().manual_seed(2))
    spans = _spans(prof)
    named = lambda n: [s for s in spans if s[0] == n]
    call, = named("cv/call")
    pro, = named("cv/prologue")
    dec, = named("cv/decode")
    assert _inside(pro, call) and _inside(dec, call)
    scales = sorted((s for s in spans if s[0].startswith("cv/scale/")), key=lambda s: s[1])
    assert [s[0] for s in scales] == [f"cv/scale/{si}" for si in range(len(PNS))]
    assert pro[2] <= scales[0][1] and scales[-1][2] <= dec[1]
    for scale in scales:
        assert _inside(scale, call)
        for name in ("cv/blocks", "cv/head", "cv/draw", "cv/canvas"):
            assert len([s for s in named(name) if _inside(s, scale)]) == 1, name
    for name in ("cv/blocks", "cv/head", "cv/draw", "cv/canvas"):
        assert len(named(name)) == len(PNS)
    assert not named("cv/tokenize") and not named("cv/wait")
