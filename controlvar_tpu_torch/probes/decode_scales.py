"""Device time of K6 (in-place decode) and K7 (flat decode) at every scale
of their paths, beside SDPA.

    python3 controlvar_tpu_torch/probes/decode_scales.py [--root DIR]

Times the kernels of the checkout at DIR (default: this one), so that two
commits can be compared in one call on one card: run it for each, in turns.
K6 runs at each (pos, l) of the ControlVAR-d24 joint path (16 CFG rows, 24
heads of 64, layer 1 of a (2, 16, 24, 1360, 64) cache), K7 at each (l, cur)
of VAR-d13 (128 CFG rows, 13 heads of 64, layer 1 of a flat (2, 128, 13,
64, 680) cache), q strided as the fused QKV gives it. Each time is one
call's device time: 20 calls captured in a CUDA graph and replayed, so
that host dispatch does not enter it. Prints one JSON line.
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
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from controlvar_tpu_torch.config import control_var_config_from_depth, var_config_from_depth
    from controlvar_tpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    bf, scale = torch.bfloat16, 0.125
    out = {"root": root, "K6": [], "K7": []}
    cfg = control_var_config_from_depth(24, multi_cond=True)
    ck, cv = randn(2, 16, 24, cfg.seq_len, 64).to(bf), randn(2, 16, 24, cfg.seq_len, 64).to(bf)
    for pos, hi in cfg.begin_ends:
        qkv = randn(16, hi - pos, 3, 24, 64)
        qkv[:, :, 0] *= 4
        q, kn, vn = qkv.to(bf).permute(2, 0, 3, 1, 4)
        kk, vv = torch.cat([ck[1, :, :, :pos], kn], 2), torch.cat([cv[1, :, :, :pos], vn], 2)
        out["K6"].append((pos, hi - pos,
                          graph_ms(lambda: A.decode_attention_inplace(q, ck, cv, kn, vn, 1, pos,
                                                                      scale)),
                          graph_ms(lambda: F.scaled_dot_product_attention(q, kk, vv,
                                                                          scale=scale))))
    del ck, cv
    cfg13 = var_config_from_depth(13)
    kt, vt = randn(2, 128, 13, 64, 680).to(bf), randn(2, 128, 13, 64, 680).to(bf)
    for lo, cur in cfg13.begin_ends:
        q = (4 * randn(128, cur - lo, 3, 13, 64)).to(bf).permute(2, 0, 3, 1, 4)[0]
        kc, vc = (t[1, ..., :cur].transpose(2, 3).contiguous() for t in (kt, vt))
        out["K7"].append((cur - lo, cur,
                          graph_ms(lambda: A.decode_attention_flat(q, kt, vt, 1, cur, scale)),
                          graph_ms(lambda: F.scaled_dot_product_attention(q, kc, vc,
                                                                          scale=scale))))
    out["K6 per call ms (x24)"] = [24 * sum(r[i] for r in out["K6"]) for i in (2, 3)]
    out["K7 per call ms (x13)"] = [13 * sum(r[i] for r in out["K7"]) for i in (2, 3)]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
