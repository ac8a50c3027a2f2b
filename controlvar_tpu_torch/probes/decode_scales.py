"""Device time of the decode kernels K1, K6, K7 and K8 at every scale of
their paths, beside SDPA.

    python3 controlvar_tpu_torch/probes/decode_scales.py [--root DIR] [--kernels K1,K8]

Times the kernels of the checkout at DIR (default: this one), so that two
commits can be compared in one call on one card: run it for each, in turns.
K1 runs at each (l, cur) of the ControlVAR-d16 serving path (64 CFG rows,
16 heads of 64, layer 1 of a (2, 64, 16, 1360, 64) cache), K6 at each (pos,
l) of the ControlVAR-d24 joint path (16 CFG rows, 24 heads of 64, layer 1
of a (2, 16, 24, 1360, 64) cache), K7 at each (l, cur) of VAR-d13 (128 CFG
rows, 13 heads of 64, layer 1 of a flat (2, 128, 13, 64, 680) cache), K8 at
each (l, cur) of VAR-d12 (128 CFG rows, 12 heads of 64, layer 1 of a fused
(2, 128, 12, 680, 128) cache); q strided as the fused QKV gives it. Each
time is one call's device time: 20 calls captured in a CUDA graph and
replayed, so that host dispatch does not enter it. SDPA runs over
contiguous K/V made outside the time. Prints one JSON line: per kernel the
(l or pos, cur or l, kernel ms, SDPA ms) of each scale, and the sums over
one call (each scale's time times the depth).
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--kernels", default="K1,K6,K7,K8")
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
