"""Decode attention over the stacked KV cache (kernel K1).

`decode_attention` is the port of `controlvar_tpu/ops/attention.py:
flash_decode_paired`: for one layer `li` of the (depth, B, H, L_max, hd)
cache it computes softmax(q*scale . K^T [mask -> -1e30]) . V over rows
[0, cur). On a CUDA tensor it launches the hand-written Hopper kernel
`csrc/decode_attention.cu`, which reads the cache in place through strides;
on a CPU tensor it takes `decode_attention_plain`, the einsum path of the JAX
package's `_mha_decode_paired` on the per-head layout, with the TPU kernel's
fp32 scores. Nothing falls back:
a CUDA input the kernel does not take raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from controlvar_tpu_torch.ops import _build

NEG_INF = -1e30  # large negative instead of -inf: keeps masked softmax NaN-free

_C = ctypes.c_void_p
_ARGTYPES = [_C, _C, _C, _C, _C] + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6 + [
    ctypes.c_float, _C]


def _lib():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _scale_in(dtype: torch.dtype, scale: float) -> torch.Tensor:
    """The attention scale rounded to the working dtype, as q*scale is."""
    return torch.tensor(scale, dtype=dtype)


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float, mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """(B, H, l, hd) x (B, H, Lk, hd) -> (B, H, l, hd): fp32 scores and
    softmax, products in q's dtype, probabilities rounded to q's dtype."""
    k = k.to(q.dtype)
    v = v.to(q.dtype)
    qs = q * _scale_in(q.dtype, scale).to(q.device)
    # fp32 scores from the rounded operands, as the TPU kernel's dot with
    # preferred_element_type=float32 gives them (an einsum in bf16 would
    # round the scores too)
    logits = torch.einsum("bhqd,bhkd->bhqk", qs.float(), k.float())
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     li: int, cur: int, scale: float,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of q (B, H, l, hd) over rows [0, cur) of layer `li` of the
    stacked caches (depth, B, H, L_max, hd); mask: optional (l, cur) bool."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache_k[li, :, :, :cur],
                                      cache_v[li, :, :, :cur], scale, mask)
    B, H, l, hd = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        if t.device != q.device or t.dtype != torch.bfloat16 or t.dim() != 5:
            raise ValueError(f"decode_attention: {name} must be a 5-D bf16 "
                             f"tensor on {q.device}, got {t.dtype} {tuple(t.shape)}")
        if t.shape[1:3] != (B, H) or t.shape[4] != hd or t.stride(4) != 1:
            raise ValueError(f"decode_attention: {name} shape {tuple(t.shape)} "
                             f"does not fit q {tuple(q.shape)}")
        if any(s % 8 for s in t.stride()[1:4]) or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} rows must be 16-byte aligned")
    if q.dtype != torch.bfloat16 or hd != 64:
        raise ValueError(f"decode_attention: the kernel takes bf16 q with "
                         f"hd=64, got {q.dtype} hd={hd}")
    if not 0 <= li < cache_k.shape[0] or not 0 < cur <= cache_k.shape[3]:
        raise ValueError(f"decode_attention: li={li}, cur={cur} out of range")
    q = q.contiguous()
    if mask is not None:
        if mask.shape != (l, cur) or mask.dtype != torch.bool or mask.device != q.device:
            raise ValueError(f"decode_attention: mask must be ({l}, {cur}) bool "
                             f"on {q.device}, got {mask.dtype} {tuple(mask.shape)}")
        mask = mask.contiguous()
    out = torch.empty_like(q)
    kl, vl = cache_k[li], cache_v[li]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib()(q.data_ptr(), kl.data_ptr(), vl.data_ptr(),
                 None if mask is None else mask.data_ptr(), out.data_ptr(),
                 B, H, l, cur, *kl.stride()[:3], *vl.stride()[:3],
                 float(_scale_in(torch.bfloat16, scale)), stream)
    _build.check(err, "decode_attention launch")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
