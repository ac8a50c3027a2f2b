"""The precision of the reference's weight products.

"fp32": every product in fp32 with TF32 off (`exact`). "fp8": the control
of the comparison, the step below the configurations' bf16: both operands
of every linear layer and convolution rounded to float8 e4m3 with one
scale per tensor (amax / 448, as fp8 training recipes scale), the product,
the gradients and everything else in fp32.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def exact():
    """fp32 matmuls and convolutions without TF32 inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale, back in fp32. The
    gradient passes through unrounded (a cast's backward would round it to
    fp8 without a scale)."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t.detach())


class Prec:
    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"precision {kind!r}: want fp32 or fp8")
        self.kind = kind

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        return fp8_round(t) if self.kind == "fp8" else t

    def linear(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        """x @ w (+ b), w stored (in, out)."""
        y = self._q(x) @ self._q(w)
        return y if b is None else y + b

    def conv(self, x: torch.Tensor, p, stride: int = 1, padding=None) -> torch.Tensor:
        """A 2-D convolution of NCHW x with p's OIHW kernel and bias; "same"
        padding for the odd kernels unless padding is given."""
        w = p["kernel"]
        if padding is None:
            padding = w.shape[-1] // 2
        return F.conv2d(self._q(x), self._q(w), p["bias"], stride=stride, padding=padding)
