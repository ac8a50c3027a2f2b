#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (controlvar_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout. Phases, each fatal on failure:
  1. environment: the card's name and power limit (nvidia-smi);
  2. build both kernels from controlvar_tpu_torch/csrc with nvcc (sm_90a);
  3. K1 decode attention vs its plain version at every scale's (l, cur) of
     the main path, and at the final scale under an `indep` mask;
  4. K2 bisection sampling vs its plain version at every scale's row count,
     then greedy, Philox and kept-set checks at the final scale, and the
     distribution of 1e4 Philox draws (and of the unfiltered categorical,
     whose noise is made on the card) against the analytic softmax;
  5. small-input reference: fp32 tokenizer ids on the GPU equal the CPU's,
     and one bf16 decode step through K1 agrees with the fp32 CPU path;
  6. the main path at full width: ControlVAR-d16 (multi_cond) and the ch-160
     VQVAE, random weights from a seed, SamplingHarness.control_conditioned
     on 16 seeded 256x256 control images (tokenize, 10 scales with 4-way CFG,
     top-k 900, top-p 0.96, decode both canvases), one warm-up call and one
     timed call, with the kernels' launch counts read around each call.
Prints the card, a `kernels` JSON line and, last, {"ok": true, "device": ...}.
It exits non-zero, printing no result, without CUDA or outside a checkout.
--profile adds a breakdown of the main path: host-clock phases (tokenize,
scales, decode), then a torch.profiler pass over one more call giving the
device busy time, the idle share and kernel time by category; its kernel
table goes to chiprun_out/chip_smoke_profile.txt.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor cores
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# K1's limits. Per element, |got - want| <= 2^-7 (|want| + mag), mag = sum_j
# p_j |v_j| (the plain version on |V|). Both sides round p to bf16 (rel. err
# <= 2^-9 each), the kernel unnormalised, the plain version normalised, which
# moves an output by up to 2^-8 mag where terms cancel; the bf16 output and
# the kernel's sum of unrounded p add up to ~3 * 2^-9 |want|. The limit is
# twice that worst case. Over a whole output, ||got - want|| <= 2^-6 ||want||,
# which a dropped or misplaced K/V tile breaks. Readings on an H100 at 700 W:
# the largest err/limit is 0.70 (1.56e-2 at cur=2, where few terms of
# magnitude ~3 cancel) and 0.28 at the final scale (3.9e-3); the relative L2
# error is 2.7e-3 to 3.1e-3 at every scale.
K1_RTOL = 2.0 ** -7
K1_REL_L2 = 2.0 ** -6


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over `reps` back-to-back calls, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_close(name, got, want, mag) -> float:
    """K1's output against its plain version within K1's limits; `mag` is
    the plain version over |V|. Returns the largest absolute error."""
    import torch

    got, want, mag = got.float(), want.float(), mag.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    err = (got - want).abs()
    limit = K1_RTOL * (want.abs() + mag)
    bad = int((err > limit).sum())
    max_err, worst = float(err.max()), float((err / limit).max())
    rel_l2 = float(err.norm() / want.norm())
    print(f"{name}: max_abs_err={max_err:.3e} largest err/limit={worst:.3f} "
          f"outside the limit={bad} rel_l2={rel_l2:.3e}")
    if bad:
        fail(f"{name}: {bad} elements outside {K1_RTOL:g} (|want| + mag)")
    if rel_l2 > K1_REL_L2:
        fail(f"{name}: relative L2 error {rel_l2:.3e} > {K1_REL_L2:g}")
    return max_err


def tv_check(name, row, ids, kept) -> None:
    """Draws `ids` of one tiled logits row against the analytic softmax over
    the kept set: every draw is kept, and the empirical total-variation
    distance is within 2x of the multinomial noise, E[TV] <= 0.5 sum
    sqrt(p(1-p)/n), plus 1e-3, as the CPU test of the sampler holds it."""
    import numpy as np

    r, k, d = (t.cpu().numpy() for t in (row.double(), kept, ids))
    e = np.where(k, np.exp(r - r.max()), 0.0)
    p, n = e / e.sum(), d.size
    if not k[d].all():
        fail(f"{name}: a draw lies outside the kept set")
    tv = 0.5 * np.abs(np.bincount(d, minlength=r.size) / n - p).sum()
    noise = 0.5 * np.sqrt(p * (1 - p) / n).sum()
    print(f"{name}: {n} draws over {int(k.sum())} kept ids, TV {tv:.4f} "
          f"(limit {2 * noise + 1e-3:.4f})")
    if tv >= 2.0 * noise + 1e-3:
        fail(f"{name}: TV {tv:.4f} beyond the multinomial noise {noise:.4f}")


def k1_phase(torch, cfg):
    """Decode attention vs its plain version; returns the kernels-line entry."""
    import torch.nn.functional as F

    from controlvar_tpu_torch.models.masks import attn_mask_for_config
    from controlvar_tpu_torch.ops.attention import decode_attention, decode_attention_plain

    g = torch.Generator(device="cuda").manual_seed(1)
    dev, bf = "cuda", torch.bfloat16
    R_B, H, hd, L = 64, cfg.num_heads, cfg.head_dim, cfg.seq_len
    scale = cfg.attn_scale
    ck = torch.randn(2, R_B, H, L, hd, generator=g, device=dev).to(bf)
    cv = torch.randn(2, R_B, H, L, hd, generator=g, device=dev).to(bf)
    # q of std 4: scores of std ~1 after the 1/32 scale, a peaked softmax
    rand_q = lambda l: (4 * torch.randn(R_B, H, l, hd, generator=g, device=dev)).to(bf)
    errs = []
    # every scale's (l, cur) of the main path, over layer 1 of the cache
    for lo, cur in cfg.begin_ends:
        q = rand_q(cur - lo)
        got = decode_attention(q, ck, cv, 1, cur, scale)
        kk, vv = ck[1, :, :, :cur], cv[1, :, :, :cur]
        want = decode_attention_plain(q, kk, vv, scale)
        mag = decode_attention_plain(q, kk, vv.abs(), scale)
        errs.append(check_close(f"K1 l={cur - lo} cur={cur}", got, want, mag))
    # masked: separate_decoding + indep mask rows of the final scale
    from controlvar_tpu_torch.config import control_var_config_from_depth

    mcfg = control_var_config_from_depth(16, multi_cond=True, separate_decoding=True,
                                         indep=True)
    lo, hi = mcfg.begin_ends[-1]
    mask = torch.from_numpy(attn_mask_for_config(mcfg)[lo:hi, :hi]).to(dev)
    if bool(mask.all()):
        fail("K1 masked case: the mask slice masks nothing")
    q = rand_q(hi - lo)
    got = decode_attention(q, ck, cv, 0, hi, scale, mask)
    kk, vv = ck[0, :, :, :hi], cv[0, :, :, :hi]
    want = decode_attention_plain(q, kk, vv, scale, mask)
    mag = decode_attention_plain(q, kk, vv.abs(), scale, mask)
    errs.append(check_close(f"K1 masked l={hi - lo} cur={hi}", got, want, mag))

    # timing at the final scale, unmasked
    l, cur = 512, L
    q = rand_q(l)
    kk, vv = ck[1, :, :, :cur], cv[1, :, :, :cur]
    ms = cuda_ms(lambda: decode_attention(q, ck, cv, 1, cur, scale), 20)
    plain_ms = cuda_ms(lambda: decode_attention_plain(q, kk, vv, scale), 5)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, kk, vv, scale=scale), 20)
    nbytes = 2 * (2 * q.numel() + 2 * R_B * H * cur * hd)   # q, out, K, V in bf16
    flops = 4 * R_B * H * l * cur * hd
    b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
    print(f"K1 final scale: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(name="decode_attention", route="cuda",
                source="controlvar_tpu_torch/csrc/decode_attention.cu",
                replaces="controlvar_tpu/ops/attention.py:403",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def k2_phase(torch, V, patch_nums):
    """Bisection sampling vs its plain version; returns the kernels-line entry."""
    from controlvar_tpu_torch.ops.sample_kernel import (
        gumbel_noise, kept_mask_plain, sample_bisect_plain, sample_top_k_top_p_bisect)
    from controlvar_tpu_torch.ops.sampling import sample_top_k_top_p

    n, top_k, top_p = 16 * 3 * patch_nums[-1] ** 2, 900, 0.96
    g = torch.Generator(device="cuda").manual_seed(2)
    logits = 3.0 * torch.randn(n, V, generator=g, device="cuda")
    logits[:, :8] += 10.0  # a peaked head, as CFG logits have
    gen = lambda seed: torch.Generator().manual_seed(seed)

    noise = gumbel_noise((n, V), gen(3), "cuda")
    # the same noise to both, at every scale's row count (B * 3 * pn^2)
    mismatch = 0.0
    for pn in patch_nums:
        m = 16 * 3 * pn * pn
        ids_k = sample_top_k_top_p_bisect(logits[:m], top_k, top_p, noise=noise[:m])
        ids_p = sample_bisect_plain(logits[:m], noise[:m], top_k, top_p)
        agree = float((ids_k == ids_p).float().mean())
        print(f"K2 noise input, {m} rows: ids equal on {agree * m:.0f}/{m} ({agree:.6f})")
        if agree < 0.999:
            fail(f"K2: ids agree on only {agree:.6f} of {m} rows")
        mismatch = max(mismatch, 1.0 - agree)

    greedy = sample_top_k_top_p_bisect(logits, 1, 0.0, generator=gen(4))
    if not torch.equal(greedy, logits.argmax(-1)):
        fail("K2: greedy draw differs from argmax")

    a = sample_top_k_top_p_bisect(logits, top_k, top_p, generator=gen(5))
    b = sample_top_k_top_p_bisect(logits, top_k, top_p, generator=gen(5))
    c = sample_top_k_top_p_bisect(logits, top_k, top_p, generator=gen(6))
    if not torch.equal(a, b):
        fail("K2 Philox: the same seed gave other ids")
    if torch.equal(a, c):
        fail("K2 Philox: two seeds gave the same ids")
    kept = kept_mask_plain(logits, top_k, top_p)
    for name, ids in (("Philox", a), ("noise input", ids_k)):
        if not bool(kept.gather(1, ids[:, None]).all()):
            fail(f"K2 {name}: a drawn id lies outside the plain kept set")
    print(f"K2: greedy == argmax, Philox draws deterministic per seed, all in "
          f"the kept set (mean kept {float(kept.sum(-1).float().mean()):.1f} ids/row)")

    # the Philox draws' distribution: 1e4 copies of a broad row (N(0, 1), some
    # hundreds kept) and of a peaked row of the logits above
    n_draw = 10_000
    broad = torch.randn(V, generator=g, device="cuda")
    for rname, row in (("broad", broad), ("peaked", logits[0])):
        ids = sample_top_k_top_p_bisect(row.expand(n_draw, V), top_k, top_p,
                                        generator=gen(8))
        tv_check(f"K2 Philox, {rname} row", row, ids,
                 kept_mask_plain(row[None], top_k, top_p)[0])
    # the unfiltered categorical makes its noise on the card
    ids = sample_top_k_top_p(broad.expand(n_draw, V), 0, 0.0, gen(9))
    if not torch.equal(ids, sample_top_k_top_p(broad.expand(n_draw, V), 0, 0.0, gen(9))):
        fail("unfiltered categorical: the same seed gave other ids")
    tv_check("unfiltered categorical, broad row", broad, ids,
             torch.ones(V, dtype=torch.bool, device="cuda"))

    ms = cuda_ms(lambda: sample_top_k_top_p_bisect(logits, top_k, top_p, generator=gen(7)), 20)
    plain_ms = cuda_ms(lambda: sample_bisect_plain(logits, noise, top_k, top_p), 3)
    nbytes = 4 * n * V + 8 * n
    # per logit: the max, 26 top-k and 26 top-p compare-and-accumulate steps
    # (2 ops each), the exp and the masked add of the draw
    ops = n * V * (1 + 2 * 26 + 2 * 26 + 1 + 2)
    b_ms, b_by = bound_ms(nbytes, ops, PEAK_FP32_FLOPS)
    print(f"K2 final scale ({n}x{V}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})")
    return dict(name="sample_top_k_top_p_bisect", route="cuda",
                source="controlvar_tpu_torch/csrc/sample_bisect.cu",
                replaces="controlvar_tpu/ops/sample_kernel.py:126",
                # ids, not values: the largest share of rows whose drawn id differs
                max_abs_err=mismatch,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def reference_phase(torch):
    """Small inputs against the CPU: fp32 tokenizer ids bit-equal; one bf16
    decode step through K1 close to the fp32 plain path."""
    from controlvar_tpu_torch.config import ControlVARConfig, VQVAEConfig
    from controlvar_tpu_torch.device import tree_to
    from controlvar_tpu_torch.models import transformer as tfm
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE

    vq_cfg = VQVAEConfig(ch=32, patch_nums=(1, 2, 4), vocab_size=64)
    vq_cpu = VQVAE(vq_cfg, device="cpu")
    vp = vq_cpu.init_params(0)
    img = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0)) * 2 - 1
    ids_cpu = vq_cpu.img_to_ids(vp, img)
    ids_gpu = VQVAE(vq_cfg, device="cuda").img_to_ids(tree_to(vp, "cuda"), img.cuda())
    for a, b in zip(ids_cpu, ids_gpu):
        if not torch.equal(a, b.cpu()):
            fail("reference: fp32 tokenizer ids on the GPU differ from the CPU's")

    cfg = ControlVARConfig(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 4),
                           vocab_size=64, cvae=32, num_classes=8, multi_cond=True)
    p = ControlVARModel(cfg, device="cpu").init_params(1)["blocks"]
    gx = torch.Generator().manual_seed(2)
    x0, x1 = (torch.randn(4, n, 128, generator=gx) for n in (2, 8))
    cond = torch.randn(4, 128, generator=gx)

    def run(device, dtype):
        bp = tree_to(p, device, dtype)
        ck, cv = tfm.init_kv_cache(cfg, 4, cfg.seq_len, dtype, device)
        _, ck, cv = tfm.blocks_decode(bp, x0.to(device, dtype), cond.to(device), cfg, ck, cv, 0)
        y, _, _ = tfm.blocks_decode(bp, x1.to(device, dtype), cond.to(device), cfg, ck, cv, 2)
        return y.float().cpu()

    want, got = run("cpu", torch.float32), run("cuda", torch.bfloat16)
    rel = float((got - want).norm() / want.norm())
    print(f"reference: tokenizer ids equal; bf16 GPU decode step vs fp32 CPU: "
          f"relative error {rel:.3e}")
    if rel > 2e-2:  # bf16 residual stream: ~3 significant digits per op
        fail(f"reference: decode step relative error {rel:.3e} > 2e-2")


def main_path_phase(torch, cfg, profile: bool):
    from controlvar_tpu_torch.config import SampleConfig, VQVAEConfig
    from controlvar_tpu_torch.eval.harness import SamplingHarness
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.ops.attention import decode_attention
    from controlvar_tpu_torch.ops.sample_kernel import sample_top_k_top_p_bisect

    B = 16
    t0 = time.time()
    model, vqvae = ControlVARModel(cfg), VQVAE(VQVAEConfig())
    harness = SamplingHarness(model, vqvae, SampleConfig())
    params = harness.prepare_params(model.init_params(0))
    vq_params = vqvae.init_params(1)
    g = torch.Generator().manual_seed(3)
    labels = torch.randint(0, cfg.num_classes, (B,), generator=g)
    cond_type = torch.randint(0, 4, (B,), generator=g)
    imgs = (torch.rand(B, 256, 256, 3, generator=g) * 2 - 1).cuda()
    print(f"main path: d16 params and ch-160 VQVAE built in {time.time() - t0:.1f} s")

    def call(seed):
        decode_attention.launches = sample_top_k_top_p_bisect.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = harness.control_conditioned(params, vq_params, labels, cond_type,
                                          torch.Generator().manual_seed(seed), imgs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = (decode_attention.launches, sample_top_k_top_p_bisect.launches)
        if counts != (cfg.depth * cfg.num_scales, cfg.num_scales):
            fail(f"main path: launches (K1, K2) = {counts}, expected "
                 f"({cfg.depth * cfg.num_scales}, {cfg.num_scales})")
        for t_ in out:
            if tuple(t_.shape) != (B, 256, 256, 3) or not torch.isfinite(t_).all():
                fail(f"main path: bad canvas {tuple(t_.shape)}")
            if float(t_.min()) < 0.0 or float(t_.max()) > 1.0:
                fail("main path: canvas outside [0, 1]")
        return dt, counts

    dt_warm, _ = call(10)
    dt, counts = call(11)
    print(f"main path: warm-up call {dt_warm:.3f} s; timed call {dt:.4f} s for "
          f"{B} images = {B / dt:.3f} img/s; launches K1={counts[0]} K2={counts[1]}")
    if profile:
        breakdown(torch, call,
                  lambda: harness.control_conditioned(params, vq_params, labels, cond_type,
                                                      torch.Generator().manual_seed(12),
                                                      imgs, decode_img=False),
                  lambda: harness._tokenize(vq_params, imgs),
                  lambda fh: vqvae.fhat_to_img(vq_params, fh, harness.compute_dtype))
    return counts, B / dt


# kernel-name substrings of each device-time category, tested in this order
CATEGORIES = (("K1 decode attention", ("decode_attention_kernel",)),
              ("K2 sampling", ("sample_bisect_kernel",)),
              ("convolution", ("fprop", "conv", "cudnn", "nchwToNhwc", "nhwcToNchw")),
              ("matmul", ("gemm", "nvjet", "cutlass", "xmma")),
              ("copy and cast", ("copy", "Memcpy", "Memset")),
              ("elementwise", ("elementwise",)),
              ("reduction and norm", ("reduce", "Moments", "norm", "softmax")))


def breakdown(torch, call, sample_only, tokenize, decode):
    """Where a main-path call's time goes: host-clock phases, then one
    profiled call's device busy time, idle share and kernel time by
    category. The table goes to chiprun_out/chip_smoke_profile.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    _, t_tok = timed(tokenize)
    (fh_c, fh_i), t_gen = timed(sample_only)
    _, t_dec = timed(lambda: decode(torch.cat([fh_c, fh_i])))
    print(f"breakdown: tokenize {t_tok:.2f} ms; tokenize + 10 scales {t_gen:.2f} ms "
          f"(scales alone {t_gen - t_tok:.2f} ms); decode both canvases {t_dec:.2f} ms")

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dt, _ = call(12)
    spans, by_cat = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name == "Command Buffer Full":
            continue
        spans.append((e.time_range.start, e.time_range.end))
        cat = next((c for c, keys in CATEGORIES if any(k in e.name for k in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    busy /= 1e3
    print(f"breakdown: profiled call {dt * 1e3:.2f} ms, device busy {busy:.2f} ms, "
          f"idle share {1 - busy / (dt * 1e3):.4f}, {len(spans)} device ops")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"breakdown: {cat}: {ms:.2f} ms")
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_profile.txt"), "w") as f:
        f.write(table)


def main() -> None:
    if not os.path.isdir(os.path.join(ROOT, "controlvar_tpu_torch")):
        fail("controlvar_tpu_torch/ not found beside chip_smoke.py: run from a checkout")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    sys.path.insert(0, ROOT)
    from controlvar_tpu_torch.config import control_var_config_from_depth
    from controlvar_tpu_torch.ops import _build

    phase("environment")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    phase("build")
    t = time.time()
    reports = _build.build(["decode_attention", "sample_bisect"])
    print(f"built {sorted(reports) or 'nothing (cached)'} in {time.time() - t:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")

    cfg = control_var_config_from_depth(16, multi_cond=True)
    phase("K1 decode attention vs plain")
    k1 = k1_phase(torch, cfg)
    phase("K2 bisection sampling vs plain")
    k2 = k2_phase(torch, cfg.vocab_size, cfg.patch_nums)
    phase("small-input reference")
    reference_phase(torch)
    phase("main path: ControlVAR-d16 control-conditioned generation, B=16")
    counts, img_s = main_path_phase(torch, cfg, "--profile" in sys.argv[1:])
    k1["launches"], k2["launches"] = counts

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"main path: {img_s:.3f} img/s on")
    print(smi)
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in (k1, k2)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
