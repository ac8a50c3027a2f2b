"""Device time of the decode kernels K1, K5, K6, K7 and K8 at every scale
of their paths, and of the flash-attention backward K4, beside SDPA.

    python3 controlvar_tpu_torch/probes/decode_scales.py [--root DIR] [--kernels K1,K5]

Times the kernels of the checkout at DIR (default: this one), so that two
commits can be compared in one call on one card: run it for each, in turns.
K1 runs at each (l, cur) of the ControlVAR-d16 serving path (64 CFG rows,
16 heads of 64, layer 1 of a (2, 64, 16, 1360, 64) cache), K5 at each (pos,
l) of the ControlVAR-d24 joint path's segmented cache at scales 1-9, over
the full prefix and over kv_window=2's (16 CFG rows, 24 heads of 64; the
prefix and the fresh rows as layer 1 of (2, 16, 24, n, 64) tensors, as
blocks_decode_seg gives them), K6 at each (pos, l) of the joint path (layer
1 of a (2, 16, 24, 1360, 64) cache), K7 at each (l, cur) of VAR-d13 (128
CFG rows, 13 heads of 64, layer 1 of a flat (2, 128, 13, 64, 680) cache),
K8 at each (l, cur) of VAR-d12 (128 CFG rows, 12 heads of 64, layer 1 of a
fused (2, 128, 12, 680, 128) cache); q strided as the fused QKV gives it.
Each decode time is one call's device time: 20 calls captured in a CUDA
graph and replayed, so that host dispatch does not enter it. SDPA runs over
contiguous K/V made outside the time. K4 runs at the d16 training shape (8,
16, 1360, 64) under the block-causal mask, q, k, v and dO strided as the
training path gives them, beside SDPA's autograd backward, each timed over
20 calls between two CUDA events, and its device time split by kernel (its
two passes, and any other kernel a call launches) with torch.profiler.
Prints one JSON line: per decode kernel the (l or pos, cur or l, kernel
ms, SDPA ms) of each scale and the sums over one call (each scale's time
times the depth); K4's and SDPA's ms and K4's split.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def graph_ms(fn, reps: int = 20) -> float:
    """One call's device time: `reps` calls captured in a CUDA graph, the
    graph replayed 5 times between two events after a warm-up, so that
    host dispatch, which exceeds the device time of the small scales'
    launches, does not enter it."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def events_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn over `reps` back-to-back calls between two
    CUDA events, after a warm-up (for work too large for host dispatch to
    matter, or that a graph cannot capture)."""
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


def kernel_split(fn, names, reps: int = 20) -> dict:
    """Device ms a call of fn by kernel (torch.profiler over `reps` calls,
    after a warm-up): each name of `names` sums the kernels whose name
    holds it, "other" the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            key = next((n for n in names if n in e.name), "other")
            split[key] = split.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / reps
    return split


def seg_scales(cfg, window):
    """(pos, l) of every K5 launch of the segmented cache path, scales 1 on:
    pos is the length of the kept earlier segments (all of them, or with a
    window the first and the last `window`, as `_windowed_segs` keeps them)."""
    lens = [cfg.scale_seg_len(si) for si in range(cfg.num_scales)]
    out = []
    for si in range(1, cfg.num_scales):
        kept = lens[:si]
        if window is not None and len(kept) > window + 1:
            kept = kept[:1] + kept[-window:]
        out.append((sum(kept), lens[si]))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--kernels", default="K1,K4,K5,K6,K7,K8")
    args = ap.parse_args()
    root, kernels = os.path.abspath(args.root), args.kernels.split(",")
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from controlvar_tpu_torch.config import control_var_config_from_depth, var_config_from_depth
    from controlvar_tpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    bf, scale = torch.bfloat16, 0.125
    out = {"root": root}

    def fresh_q(B, l, H):
        """q of std 4, the strided (B, H, l, 64) view of a fused QKV output."""
        return (4 * randn(B, l, 3, H, 64)).to(bf).permute(2, 0, 3, 1, 4)[0]

    if "K1" in kernels:
        cfg16 = control_var_config_from_depth(16, multi_cond=True)
        ck, cv = (randn(2, 64, 16, cfg16.seq_len, 64).to(bf) for _ in range(2))
        out["K1"] = []
        for lo, cur in cfg16.begin_ends:
            q = fresh_q(64, cur - lo, 16)
            kc, vc = ck[1, :, :, :cur].contiguous(), cv[1, :, :, :cur].contiguous()
            out["K1"].append((cur - lo, cur,
                              graph_ms(lambda: A.decode_attention(q, ck, cv, 1, cur, scale)),
                              graph_ms(lambda: F.scaled_dot_product_attention(q, kc, vc,
                                                                              scale=scale))))
        out["K1 per call ms (x16)"] = [16 * sum(r[i] for r in out["K1"]) for i in (2, 3)]
        del ck, cv, kc, vc
    if "K5" in kernels:
        cfg = control_var_config_from_depth(24, multi_cond=True)
        for name, window in (("full prefix", None), ("kv_window=2", 2)):
            key = f"K5 {name}"
            out[key] = []
            for pos, l in seg_scales(cfg, window):
                pre, seg = randn(2, 2, 16, 24, pos, 64).to(bf), randn(2, 2, 16, 24, l, 64).to(bf)
                args = (fresh_q(16, l, 24), pre[0, 1], pre[1, 1], seg[0, 1], seg[1, 1])
                kk, vv = torch.cat([args[1], args[3]], 2), torch.cat([args[2], args[4]], 2)
                out[key].append((pos, l,
                                 graph_ms(lambda: A.decode_attention_prefix(*args, scale)),
                                 graph_ms(lambda: F.scaled_dot_product_attention(
                                     args[0], kk, vv, scale=scale))))
            out[f"{key} per call ms (x24)"] = [24 * sum(r[i] for r in out[key]) for i in (2, 3)]
            del pre, seg, kk, vv
    if "K4" in kernels:
        from controlvar_tpu_torch.models.masks import attn_mask_for_config

        cfg16 = control_var_config_from_depth(16, multi_cond=True)
        mask = torch.from_numpy(attn_mask_for_config(cfg16)).cuda()
        L, sc = cfg16.seq_len, cfg16.attn_scale
        qkv = randn(8, L, 3, 16, 64)
        qkv[:, :, 0] *= 4.0
        q, k, v = qkv.to(bf).permute(2, 0, 3, 1, 4)
        do = randn(8, L, 16, 64).to(bf).transpose(1, 2)
        flags = A.tile_flags(mask)
        o, lse = A.flash_attention(q, k, v, mask, sc, flags)
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask, scale=sc)
        bwd = lambda: A.flash_attention_bwd(q, k, v, mask, o, lse, do, sc, flags)
        out["K4 d16 train (ms, sdpa backward ms)"] = (
            events_ms(bwd),
            events_ms(lambda: torch.autograd.grad(o_lib, (qq, kk, vv), do, retain_graph=True)))
        out["K4 d16 train, device ms a call by kernel"] = kernel_split(
            bwd, ("flash_bwd_dq", "flash_bwd_dkv"))
        del qkv, q, k, v, do, o, qq, kk, vv, o_lib
    if "K6" in kernels:
        cfg = control_var_config_from_depth(24, multi_cond=True)
        ck, cv = (randn(2, 16, 24, cfg.seq_len, 64).to(bf) for _ in range(2))
        out["K6"] = []
        for pos, hi in cfg.begin_ends:
            qkv = randn(16, hi - pos, 3, 24, 64)
            qkv[:, :, 0] *= 4
            q, kn, vn = qkv.to(bf).permute(2, 0, 3, 1, 4)
            kk = torch.cat([ck[1, :, :, :pos], kn], 2)
            vv = torch.cat([cv[1, :, :, :pos], vn], 2)
            out["K6"].append((pos, hi - pos,
                              graph_ms(lambda: A.decode_attention_inplace(q, ck, cv, kn, vn, 1,
                                                                          pos, scale)),
                              graph_ms(lambda: F.scaled_dot_product_attention(q, kk, vv,
                                                                              scale=scale))))
        out["K6 per call ms (x24)"] = [24 * sum(r[i] for r in out["K6"]) for i in (2, 3)]
        del ck, cv
    if "K7" in kernels:
        cfg13 = var_config_from_depth(13)
        kt, vt = randn(2, 128, 13, 64, 680).to(bf), randn(2, 128, 13, 64, 680).to(bf)
        out["K7"] = []
        for lo, cur in cfg13.begin_ends:
            q = fresh_q(128, cur - lo, 13)
            kc, vc = (t[1, ..., :cur].transpose(2, 3).contiguous() for t in (kt, vt))
            out["K7"].append((cur - lo, cur,
                              graph_ms(lambda: A.decode_attention_flat(q, kt, vt, 1, cur, scale)),
                              graph_ms(lambda: F.scaled_dot_product_attention(q, kc, vc,
                                                                              scale=scale))))
        out["K7 per call ms (x13)"] = [13 * sum(r[i] for r in out["K7"]) for i in (2, 3)]
        del kt, vt
    if "K8" in kernels:
        cfg12 = var_config_from_depth(12)
        kv = randn(2, 128, 12, cfg12.seq_len, 128).to(bf)
        out["K8"] = []
        for lo, cur in cfg12.begin_ends:
            q = fresh_q(128, cur - lo, 12)
            kc, vc = kv[1, :, :, :cur, :64].contiguous(), kv[1, :, :, :cur, 64:].contiguous()
            out["K8"].append((cur - lo, cur,
                              graph_ms(lambda: A.decode_attention_fused(q, kv, 1, cur, scale)),
                              graph_ms(lambda: F.scaled_dot_product_attention(q, kc, vc,
                                                                              scale=scale))))
        out["K8 per call ms (x12)"] = [12 * sum(r[i] for r in out["K8"]) for i in (2, 3)]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
