"""LPIPS perceptual distance (frozen VGG16 features + learned 1x1 heads).

The port of `controlvar_tpu/losses/lpips.py` (reference: losses/lpips.py:
11-54): scaling layer -> VGG16 relu1_2/2_2/3_3/4_3/5_3 features ->
channel-unit-normalize -> learned 1x1 linear heads -> spatial mean -> sum.
Images and features are NHWC at the interface; the convs run NCHW.

Weights: the reference downloads `vgg.pth` (the taming-transformers
checkpoint, reference: losses/util.py:5-7); `convert_lpips_state_dict`
imports it. `init_params` gives random weights (tests, card runs).

Params: {"stages": [[{"kernel": (O, I, 3, 3), "bias": (O,)} x n] x 5],
         "lins": [(C,) x 5]}
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from controlvar_tpu_torch.device import DeviceLike, resolve_device

Params = Dict

# VGG16 conv plan: (out_channels, layers_in_stage); features tapped at each
# stage's last relu
VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

# ImageNet scaling constants (reference: lpips.py ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def vgg_features(params: Params, x: torch.Tensor) -> List[torch.Tensor]:
    """x (B, H, W, 3) in [-1, 1] -> 5 feature maps (B, h, w, C), after each
    stage, 2x2 max-pooled between stages."""
    shift = x.new_tensor(_SHIFT)
    scale = x.new_tensor(_SCALE)
    h = ((x - shift) / scale).permute(0, 3, 1, 2)
    feats = []
    for si, (_, n_layers) in enumerate(VGG_STAGES):
        for li in range(n_layers):
            p = params["stages"][si][li]
            h = F.relu(F.conv2d(h, p["kernel"].to(h.dtype), p["bias"].to(h.dtype), padding=1))
        feats.append(h.permute(0, 2, 3, 1))
        if si < len(VGG_STAGES) - 1:
            h = F.max_pool2d(h, 2, 2)
    return feats


def lpips_distance(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample LPIPS distance (B,)."""
    fx = vgg_features(params, x)
    fy = vgg_features(params, y)
    total = 0.0
    for si, (a, b) in enumerate(zip(fx, fy)):
        an = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True).clamp_min(1e-10)
        bn = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True).clamp_min(1e-10)
        d = (an - bn) ** 2
        w = params["lins"][si]  # (C,) 1x1 head weights (non-negative in the ckpt)
        total = total + torch.mean(torch.sum(d * w, dim=-1), dim=(1, 2))
    return total


def init_params(generator: torch.Generator) -> Params:
    """Random weights on the CPU: torch-default U(+-1/sqrt(fan_in)) convs,
    heads U(0, 0.1)."""
    stages = []
    cin = 3
    for cout, n_layers in VGG_STAGES:
        layer_ps = []
        for _ in range(n_layers):
            bound = 1.0 / np.sqrt(3 * 3 * cin)
            layer_ps.append({
                "kernel": (torch.rand(cout, cin, 3, 3, generator=generator) * 2 - 1) * bound,
                "bias": (torch.rand(cout, generator=generator) * 2 - 1) * bound,
            })
            cin = cout
        stages.append(layer_ps)
    lins = [torch.rand(cout, generator=generator) * 0.1 for cout, _ in VGG_STAGES]
    return {"stages": stages, "lins": lins}


# torchvision vgg16.features indices of the convs of each stage
_CONV_IDX = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))


def convert_lpips_state_dict(sd: Dict, device: DeviceLike = None) -> Params:
    """Import the taming-transformers `vgg.pth` LPIPS checkpoint (arrays or
    tensors; conv weights `net.slice{s}.{i}.*` or `net.features.{i}.*`,
    heads `lin{i}.model.1.weight`) onto `device` (the GPU unless
    device="cpu"). Kernels stay OIHW."""
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(device)

    def get(si, i, what):
        key = f"net.slice{si + 1}.{i}.{what}"
        return sd[key] if key in sd else sd[f"net.features.{i}.{what}"]

    stages = [[{"kernel": t(get(si, i, "weight")), "bias": t(get(si, i, "bias"))}
               for i in idxs] for si, idxs in enumerate(_CONV_IDX)]
    lins = [t(sd[f"lin{i}.model.1.weight"]).reshape(-1) for i in range(5)]
    return {"stages": stages, "lins": lins}
