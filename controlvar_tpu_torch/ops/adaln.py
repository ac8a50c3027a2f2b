"""The transformer blocks' AdaLN chains: LayerNorm, modulation and gated
residual, one kernel a site (no TPU kernel: XLA fused these chains under jit).

A layer of `models/transformer.py` meets the rows (g1, g2, s1, s2, sh1, sh2)
of its fp32 modulation (B, 6, C) at three sites:
  `adaln_norm`      hn  = LN(h) (1 + s1) + sh1                  QKV's input
  `adaln_add_norm`  h'  = h + g1 (y + b) keep,                  after the projection
                    hn  = LN(h') (1 + s2) + sh2                 the FFN's input
  `adaln_add`       h'' = h' + g2 (f + b) keep                  after fc2
LN is `layer_norm`: affine-free, fp32 two-pass statistics. h is the residual
stream (B, l, C); a row (g, s or sh) is (B, 1, C), or (1, 1, C) for all of
h's rows, as the blocks cut it from the modulation; y and f are the
projections' outputs before their bias b, in h's dtype, or fp32 summed over
a tensor-parallel model group, whose bias is then fp32 too; keep, optional,
the branch's (B,) drop-path factors.

The plain versions (`*_plain`) are the eager chains op for op, with their
roundings to the residual dtype after LN, the modulation, the bias add and
the gate. On CUDA tensors the wrappers launch `csrc/adaln.cu`, one pass a
site, which keeps every value in fp32 from its load to one store in the
residual dtype: it drops those intermediate roundings and adds none.

Dispatch, by what the inputs show: the plain version for CPU tensors, and
under autograd when an input requires grad (the kernels have no backward:
the train step, LoRA, the Trainer); otherwise the kernel. A CUDA input the
kernel does not take raises: nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from controlvar_tpu_torch.ops import _build

MAX_WIDTH = 8192                      # C: 8 columns a thread, 1024 threads a block

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_C, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "adaln_norm": [_I, _C, _C, _C, _LL, _C, _I, _I, _I, ctypes.c_float, _C],
    "adaln_add_norm": [_I, _I, _C, _C, _C, _C, _C, _C, _LL, _C, _C, _C, _I, _I, _I,
                       ctypes.c_float, _C],
    "adaln_add": [_I, _I, _C, _C, _C, _C, _LL, _C, _C, _I, _I, _I, _C],
}


def _entry(name: str):
    return _build.entry("adaln", name, _ARGTYPES[name])


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-free LayerNorm with fp32 statistics, cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def adaln_norm_plain(h: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                     eps: float) -> torch.Tensor:
    hn = layer_norm(h, eps)
    return (hn.float() * (scale + 1.0) + shift).to(h.dtype)


def adaln_add_plain(h: torch.Tensor, f: torch.Tensor, bias: torch.Tensor, gate: torch.Tensor,
                    keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    o = f + bias.to(f.dtype)
    o = (o.float() * gate).to(h.dtype)
    if keep is not None:
        o = o * keep.reshape(-1, 1, 1)
    return h + o


def adaln_add_norm_plain(h: torch.Tensor, y: torch.Tensor, bias: torch.Tensor,
                         gate: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                         eps: float, keep: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = adaln_add_plain(h, y, bias, gate, keep)
    return h, adaln_norm_plain(h, scale, shift, eps)


def _takes_kernel(what: str, *tensors) -> bool:
    """Whether `what` launches its kernel on these inputs (module docstring)."""
    device = tensors[0].device
    if device.type == "cpu":
        return False
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        return False
    if device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {device}")
    return True


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it, dense and starting 16-byte aligned."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _residual(what, h):
    """h checked: (B, l, C) bf16 or fp32, dense."""
    if (h.dim() != 3 or h.dtype not in _DTYPES or h.shape[2] % 8
            or not 0 < h.shape[2] <= MAX_WIDTH):
        raise ValueError(f"{what}: the kernel takes a (B, l, C) bf16 or fp32 residual with C "
                         f"a multiple of 8 up to {MAX_WIDTH}, got {h.dtype} {tuple(h.shape)}")
    if not 0 < h.shape[0] <= 65535 or h.shape[1] == 0:
        raise ValueError(f"{what}: B = {h.shape[0]} (at most 65535) and l = {h.shape[1]} "
                         f"(at least 1)")
    return _dense(h)


def _rows(what, h, *rows):
    """The modulation rows checked, and their common batch stride (0 for
    one row for all): each (B or 1, 1, C) fp32. Views of one modulation, as
    the blocks cut them, are read in place where their rows are dense and
    16-byte aligned; other rows are copied dense."""
    B, _, C = h.shape
    n = rows[0].shape[0]
    for r in rows:
        if (r.dtype != torch.float32 or tuple(r.shape) != (n, 1, C) or n not in (1, B)
                or r.device != h.device):
            raise ValueError(f"{what}: modulation rows must be ({B} or 1, 1, {C}) fp32 on "
                             f"{h.device}, got {r.dtype} {tuple(r.shape)} on {r.device}")
    sb = rows[0].stride(0) if n > 1 else 0
    if sb % 4 or any(r.stride(2) != 1 or r.data_ptr() % 16 or (n > 1 and r.stride(0) != sb)
                     for r in rows):
        rows = tuple(_dense(r) for r in rows)
        sb = C if n > 1 else 0
    return rows, sb


def _branch(what, h, y, bias, keep):
    """y, its bias in y's dtype and keep as (B,) fp32, checked."""
    B, _, C = h.shape
    if (y.shape != h.shape or y.dtype not in _DTYPES or y.device != h.device
            or bias.shape != (C,) or bias.device != h.device):
        raise ValueError(f"{what}: y must be {tuple(h.shape)} bf16 or fp32 and the bias "
                         f"({C},) on {h.device}, got {y.dtype} {tuple(y.shape)} and "
                         f"{tuple(bias.shape)}")
    if keep is not None:
        if keep.numel() != B or keep.device != h.device:
            raise ValueError(f"{what}: keep must hold {B} factors on {h.device}, got "
                             f"{tuple(keep.shape)} on {keep.device}")
        keep = keep.reshape(B).float().contiguous()
    return _dense(y), _dense(bias.to(y.dtype)), keep


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def adaln_norm(h: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
               eps: float) -> torch.Tensor:
    """The attention's input: LN(h) (1 + scale) + shift in h's dtype."""
    if not _takes_kernel("adaln_norm", h, scale, shift):
        return adaln_norm_plain(h, scale, shift, eps)
    h = _residual("adaln_norm", h)
    (scale, shift), sb = _rows("adaln_norm", h, scale, shift)
    hn = torch.empty_like(h)
    B, l, C = h.shape
    err = _entry("adaln_norm")(_DTYPES[h.dtype], h.data_ptr(), scale.data_ptr(),
                               shift.data_ptr(), sb, hn.data_ptr(), B, l, C, float(eps),
                               _stream(h))
    _build.check(err, "adaln_norm launch")
    adaln_norm.launches += 1
    return hn


def adaln_add_norm(h: torch.Tensor, y: torch.Tensor, bias: torch.Tensor, gate: torch.Tensor,
                   scale: torch.Tensor, shift: torch.Tensor, eps: float,
                   keep: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention branch's gated residual h' = h + gate (y + bias) keep
    and the FFN's input LN(h') (1 + scale) + shift, both in h's dtype."""
    if not _takes_kernel("adaln_add_norm", h, y, bias, gate, scale, shift, keep):
        return adaln_add_norm_plain(h, y, bias, gate, scale, shift, eps, keep)
    h = _residual("adaln_add_norm", h)
    (gate, scale, shift), sb = _rows("adaln_add_norm", h, gate, scale, shift)
    y, bias, keep = _branch("adaln_add_norm", h, y, bias, keep)
    h_out, hn = torch.empty_like(h), torch.empty_like(h)
    B, l, C = h.shape
    err = _entry("adaln_add_norm")(_DTYPES[h.dtype], _DTYPES[y.dtype], h.data_ptr(),
                                   y.data_ptr(), bias.data_ptr(), gate.data_ptr(),
                                   scale.data_ptr(), shift.data_ptr(), sb, _ptr(keep),
                                   h_out.data_ptr(), hn.data_ptr(), B, l, C, float(eps),
                                   _stream(h))
    _build.check(err, "adaln_add_norm launch")
    adaln_add_norm.launches += 1
    return h_out, hn


def adaln_add(h: torch.Tensor, f: torch.Tensor, bias: torch.Tensor, gate: torch.Tensor,
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The FFN branch's gated residual h + gate (f + bias) keep in h's dtype."""
    if not _takes_kernel("adaln_add", h, f, bias, gate, keep):
        return adaln_add_plain(h, f, bias, gate, keep)
    h = _residual("adaln_add", h)
    (gate,), sb = _rows("adaln_add", h, gate)
    f, bias, keep = _branch("adaln_add", h, f, bias, keep)
    out = torch.empty_like(h)
    B, l, C = h.shape
    err = _entry("adaln_add")(_DTYPES[h.dtype], _DTYPES[f.dtype], h.data_ptr(), f.data_ptr(),
                              bias.data_ptr(), gate.data_ptr(), sb, _ptr(keep),
                              out.data_ptr(), B, l, C, _stream(h))
    _build.check(err, "adaln_add launch")
    adaln_add.launches += 1
    return out


adaln_norm.launches = adaln_add_norm.launches = adaln_add.launches = 0
