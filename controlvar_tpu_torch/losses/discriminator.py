"""PatchGAN discriminator (Pix2Pix style, 3 layers, ndf 64).

The port of `controlvar_tpu/losses/discriminator.py` (reference
NLayerDiscriminator, losses/discriminator.py:17-66): 4x4 convs at padding
1, stride 2 but for the last two, BatchNorm + LeakyReLU(0.2) between them,
1-channel patch logits. BatchNorm normalizes by the batch's statistics
(biased variance) and keeps no running state: the discriminator never runs
in eval. Images and logits are NHWC at the interface.

Params: {"layers": [{"conv": {"kernel": (O, I, 4, 4), "bias"}, "bn": None
or {"scale", "bias"}}, ...]}, "bn" None on the first and last layers.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict


def _conv_init(g: torch.Generator, k: int, cin: int, cout: int, std: float = 0.02) -> Params:
    # reference weights_init: normal(0, 0.02) (discriminator.py:8-14)
    return {"kernel": std * torch.randn(cout, cin, k, k, generator=g),
            "bias": torch.zeros(cout)}


def init_params(generator: torch.Generator, input_nc: int = 3, ndf: int = 64,
                n_layers: int = 3) -> Params:
    """Reference-default weights on the CPU."""
    layers = [{"conv": _conv_init(generator, 4, input_nc, ndf), "bn": None}]
    nf = ndf
    for n in range(1, n_layers + 1):
        nf_prev, nf = nf, min(ndf * 2 ** n, ndf * 8)
        layers.append({
            "conv": _conv_init(generator, 4, nf_prev, nf),
            "bn": {"scale": 1.0 + 0.02 * torch.randn(nf, generator=generator),
                   "bias": torch.zeros(nf)},
        })
    layers.append({"conv": _conv_init(generator, 4, nf, 1), "bn": None})
    return {"layers": layers}


def _conv(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    # torch Conv2d(k=4, stride, padding=1)
    return F.conv2d(x, p["kernel"].to(x.dtype), p["bias"].to(x.dtype), stride=stride,
                    padding=1)


def _bn(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm over (N, H, W) of NCHW with the batch's fp32 statistics."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3), keepdim=True)
    var = xf.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps)
    return (xn * p["scale"][:, None, None] + p["bias"][:, None, None]).to(x.dtype)


def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, 3) -> patch logits (B, h', w', 1)."""
    layers = params["layers"]
    n_layers = len(layers) - 2
    h = F.leaky_relu(_conv(layers[0]["conv"], x.permute(0, 3, 1, 2), 2), 0.2)
    for n in range(1, n_layers + 1):
        stride = 2 if n < n_layers else 1
        h = _bn(layers[n]["bn"], _conv(layers[n]["conv"], h, stride))
        h = F.leaky_relu(h, 0.2)
    return _conv(layers[-1]["conv"], h, 1).permute(0, 2, 3, 1)
