"""Does the launch order of the q tiles decide K6's and K7's time?

    python -m controlvar_tpu_torch.probes.grid_order --src DIR

DIR holds the first designs of `decode_prefix.cu` and `decode_flat.cu`
(e.g. `git archive 78149c8 controlvar_tpu_torch/csrc`): one block per
(64-row q tile, batch*head) with grid (B*H, q tiles), so the q tiles of a
head are B*H blocks apart in launch order. The probe builds each source as
it is and with the two grid dimensions swapped (the q tile fastest, so the
tiles of one head run together and share its K/V through L2), and times
both at chip_smoke.py's final-scale shapes in the order as-is, swapped,
swapped, as-is. Nothing else of the kernels changes. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from controlvar_tpu_torch.ops import _build
from controlvar_tpu_torch.ops import attention as A

SOURCES = ("decode_prefix", "decode_flat")


def _swap(text: str) -> str:
    grid = "dim3 grid(B * H, (l + BQ - 1) / BQ);"
    if text.count(grid) != 1:
        raise SystemExit("grid_order: the source is not the first design's")
    text = text.replace("blockIdx.x", "@X@").replace("blockIdx.y", "blockIdx.x")
    return text.replace("@X@", "blockIdx.y").replace(grid, "dim3 grid((l + BQ - 1) / BQ, B * H);")


def _variant(src: str, name: str, swap: bool) -> str:
    out = os.path.join(os.path.dirname(_build.BUILD_DIR), "grid_order", name)
    os.makedirs(out, exist_ok=True)
    for s in SOURCES:
        with open(os.path.join(src, s + ".cu")) as f:
            text = f.read()
        with open(os.path.join(out, s + ".cu"), "w") as f:
            f.write(_swap(text) if swap else text)
    return out


def _use(csrc: str) -> None:
    _build.CSRC = csrc
    _build._libs.clear()
    _build.build(SOURCES)


def _ms(fn, reps: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    src = ap.parse_args().src
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    randn = lambda *s: torch.randn(*s, generator=g, device="cuda").to(bf)
    # K6: d24 joint final scale, 16 CFG rows x 24 heads, l 512 over pos 848
    q6, kn, vn = randn(3, 16, 24, 512, 64).unbind(0)
    ck, cv = randn(2, 16, 24, 1360, 64), randn(2, 16, 24, 1360, 64)
    # K7: VAR-d13 final scale, 128 CFG rows x 13 heads, l 256 over cur 680
    q7 = randn(128, 13, 256, 64)
    kt, vt = randn(2, 128, 13, 64, 680), randn(2, 128, 13, 64, 680)
    k6 = lambda: A.decode_attention_inplace(q6, ck, cv, kn, vn, 1, 848, 0.125)
    k7 = lambda: A.decode_attention_flat(q7, kt, vt, 1, 680, 0.125)
    variants = {"as_is": _variant(src, "as_is", False), "swapped": _variant(src, "swapped", True)}
    times = {name: {"K6": [], "K7": []} for name in variants}
    outs = {}
    for name in ("as_is", "swapped", "swapped", "as_is"):
        _use(variants[name])
        times[name]["K6"].append(_ms(k6))
        times[name]["K7"].append(_ms(k7))
        outs.setdefault(name, (k6(), k7()))
    same = all(torch.equal(a, b) for a, b in zip(outs["as_is"], outs["swapped"]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "ms": times, "outputs_equal": same}))


if __name__ == "__main__":
    main()
