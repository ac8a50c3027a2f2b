"""Torch-parity separable image resizes, as matrix products.

Area (adaptive average pooling) and bicubic (a=-0.75, align_corners=False,
edge-clamped taps) resizes are separable linear maps: an (out, in) row
matrix is built once in numpy and applied as two matmuls,
    y = A_h @ x @ A_w^T,
in fp32, in the same order as the JAX package, so token streams follow it op
for op. Callers keep TF32 off (see models/quantizer.no_tf32).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resize_matrix", "resize_area", "resize_bicubic", "upsample_nearest_2x"]


def _cubic_weight(x: float, a: float = -0.75) -> float:
    x = abs(x)
    if x <= 1.0:
        return (a + 2.0) * x**3 - (a + 3.0) * x**2 + 1.0
    if x < 2.0:
        return a * x**3 - 5.0 * a * x**2 + 8.0 * a * x - 4.0 * a
    return 0.0


@functools.lru_cache(maxsize=None)
def _resize_matrix_np(n_in: int, n_out: int, mode: str) -> np.ndarray:
    """(n_out, n_in) float32 row-interpolation matrix."""
    W = np.zeros((n_out, n_in), dtype=np.float64)
    if mode == "area":
        for i in range(n_out):
            lo = (i * n_in) // n_out
            hi = -((-(i + 1) * n_in) // n_out)  # ceil((i+1)*n_in/n_out)
            W[i, lo:hi] = 1.0 / (hi - lo)
    elif mode == "bicubic":
        scale = n_in / n_out
        for i in range(n_out):
            src = (i + 0.5) * scale - 0.5
            f = math.floor(src)
            t = src - f
            for tap, dist in ((f - 1, 1.0 + t), (f, t), (f + 1, 1.0 - t), (f + 2, 2.0 - t)):
                j = min(max(tap, 0), n_in - 1)  # edge clamp (replicate)
                W[i, j] += _cubic_weight(dist)
    else:
        raise ValueError(f"unknown resize mode: {mode}")
    return W.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resize_matrix_cached(n_in: int, n_out: int, mode: str, device: torch.device):
    return torch.from_numpy(_resize_matrix_np(n_in, n_out, mode)).to(device)


def resize_matrix(n_in: int, n_out: int, mode: str,
                  device="cpu") -> torch.Tensor:
    return _resize_matrix_cached(n_in, n_out, mode, torch.device(device))


def _apply_separable(x: torch.Tensor, out_h: int, out_w: int, mode: str) -> torch.Tensor:
    """x: (..., H, W, C) NHWC -> (..., out_h, out_w, C), computed in fp32."""
    h, w = x.shape[-3], x.shape[-2]
    if h == out_h and w == out_w:
        return x
    dtype = x.dtype
    xf = x.float()
    Ah = resize_matrix(h, out_h, mode, x.device)
    Aw = resize_matrix(w, out_w, mode, x.device)
    y = torch.einsum("oh,...hwc->...owc", Ah, xf)
    y = torch.einsum("pw,...owc->...opc", Aw, y)
    return y.to(dtype)


def resize_area(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Torch F.interpolate(mode='area') on NHWC input, as matrices."""
    return _apply_separable(x, out_h, out_w, "area")


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Torch F.interpolate(mode='bicubic', align_corners=False) on NHWC input."""
    return _apply_separable(x, out_h, out_w, "bicubic")


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Exact nearest 2x upsample of an NCHW tensor (the VQVAE decoder runs
    NCHW inside): every pixel becomes a 2x2 block."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
