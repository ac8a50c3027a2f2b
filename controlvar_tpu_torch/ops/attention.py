"""Attention kernels of the port: decode attention (K1) and the training
flash attention forward (K3) and backward (K4).

`decode_attention` is the port of `controlvar_tpu/ops/attention.py:
flash_decode_paired`: for one layer `li` of the (depth, B, H, L_max, hd)
cache it computes softmax(q*scale . K^T [mask -> -1e30]) . V over rows
[0, cur). On a CUDA tensor it launches the hand-written Hopper kernel
`csrc/decode_attention.cu`, which reads the cache in place through strides;
on a CPU tensor it takes `decode_attention_plain`, the einsum path of the JAX
package's `_mha_decode_paired` on the per-head layout, with the TPU kernel's
fp32 scores.

`flash_attention` (K3, the port of `flash_attention(..., return_lse=True)`)
and `flash_attention_bwd` (K4, the port of `flash_attention_bwd`) launch
`csrc/flash_attention.cu` on CUDA tensors and take `flash_attention_plain`
and `flash_attention_bwd_plain` on CPU tensors. `flash_mha` is the
differentiable attention of the training forward, an autograd Function
whose forward is K3 and whose backward is K4. The JAX package's switches
around its backward (`CONTROLVAR_FLASH_BWD`, and the layer-scan chunking of
`CONTROLVAR_SCAN_CHUNK`) are not ported: they worked around a TPU compiler
that hung on the Pallas backward inside a long scan. The port always takes
K4 on the card.

Nothing falls back: a CUDA input a kernel does not take raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

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


# ---------------------------------------------------------------------------
# training attention: K3 (forward with LSE) and K4 (backward)
# ---------------------------------------------------------------------------

_FWD_ARGTYPES = ([_C] + [ctypes.c_longlong] * 3) * 3 + [_C] * 4 + [ctypes.c_int] * 3 + [
    ctypes.c_float, _C]
_BWD_ARGTYPES = ([_C] + [ctypes.c_longlong] * 3) * 4 + [_C] * 7 + [ctypes.c_int] * 3 + [
    ctypes.c_float, _C]
_TILE = 64  # rows of the kernels' tiles


def _flash_lib(name: str, argtypes):
    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 for bf16/fp32 inputs (the kernels' accumulators), fp64 for fp64
    (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def _scores(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor,
            scale: float) -> torch.Tensor:
    """(q*scale rounded to q's dtype) . K^T in the accumulator dtype, masked
    scores at -1e30: the TPU kernels' S, forward and backward alike."""
    acc = _acc_dtype(q.dtype)
    qs = q * _scale_in(q.dtype, scale).to(q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qs.to(acc), k.to(acc))
    return torch.where(mask, s, NEG_INF)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor, scale: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, L, hd) q, k, v and an (L, L) bool mask -> (out (B, H, L, hd) in
    q's dtype, lse (B, H, L) fp32). Scores, softmax sums and the PV product
    accumulate in fp32; p is rounded to q's dtype before PV, and out =
    acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)), as in the TPU kernel."""
    acc = _acc_dtype(q.dtype)
    s = _scores(q, k, mask, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).to(acc), v.to(acc))
    return (o / l).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              mask: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                              g: torch.Tensor, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of flash attention given the forward's out and lse and the
    cotangent g of out. P = exp(S - lse) is recomputed from the same rounded
    q*scale; D = rowsum(g * out) in fp32; p is rounded to q's dtype for dv and
    dS = P (dP - D) before dS.K and dS^T.q; dq and dk are multiplied by scale
    once, after accumulating, and dk contracts with the unscaled q."""
    acc, dt = _acc_dtype(q.dtype), q.dtype
    p = torch.exp(_scores(q, k, mask, scale) - lse[..., None].to(acc))
    d = (g.to(acc) * out.to(acc)).sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dt).to(acc), g.to(acc))
    dp = torch.einsum("bhqd,bhkd->bhqk", g.to(acc), v.to(acc))
    ds = (p * (dp - d)).to(dt).to(acc)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.to(acc)) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(acc)) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check_operand(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.bfloat16 or tuple(t.shape) != shape:
        raise ValueError(f"flash attention: {name} must be a bf16 {shape} tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"flash attention: {name} rows must be dense and 16-byte "
                         f"aligned, got strides {t.stride()}")


def _check_inputs(q, k, v, mask, what: str):
    """Device dispatch and checks shared by K3 and K4; True for the CPU path."""
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.dim() != 4 or q.shape[3] != 64:
        raise ValueError(f"{what}: the kernel takes (B, H, L, 64) bf16 q, got "
                         f"{q.dtype} {tuple(q.shape)}")
    shape = tuple(q.shape)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, shape, q.device)
    L = shape[2]
    if mask.shape != (L, L) or mask.dtype != torch.bool or mask.device != q.device:
        raise ValueError(f"{what}: mask must be ({L}, {L}) bool on {q.device}, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    return False


def tile_flags(mask: torch.Tensor) -> torch.Tensor:
    """(nt, nt) uint8, nt = ceil(L / 64), one flag per 64 x 64 tile of the
    (L, L) mask, over its part inside L: 1 where it has no False, 2 where it
    has no True, 0 where it has both. The kernels read mask bytes only in
    tiles flagged 0; a model computes the flags once beside its mask."""
    L = mask.shape[0]
    nt = -(-L // _TILE)
    padded = mask.new_zeros(nt * _TILE, nt * _TILE)
    padded[:L, :L] = mask
    tiles = padded.view(nt, _TILE, nt, _TILE)
    empty = ~tiles.any(dim=3).any(dim=1)
    padded[L:] = True
    padded[:, L:] = True
    full = tiles.all(dim=3).all(dim=1)
    return (full.to(torch.uint8) + 2 * empty.to(torch.uint8)).contiguous()


def _kernel_flags(mask: torch.Tensor, flags: Optional[torch.Tensor]) -> torch.Tensor:
    """The given tile flags of `mask`, checked, or computed when None."""
    if flags is None:
        return tile_flags(mask)
    nt = -(-mask.shape[0] // _TILE)
    if (flags.shape != (nt, nt) or flags.dtype != torch.uint8
            or flags.device != mask.device or not flags.is_contiguous()):
        raise ValueError(f"flash attention: flags must be contiguous ({nt}, {nt}) uint8 "
                         f"on {mask.device}, got {flags.dtype} {tuple(flags.shape)}")
    return flags


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, scale: float, flags: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked attention forward with the per-row LSE (kernel K3).

    q, k, v: (B, H, L, hd), any (batch, head, row) strides with dense rows;
    mask: (L, L) bool, True = attend; flags: `tile_flags(mask)`, computed
    here when not given. Returns (out (B, H, L, hd) contiguous, lse (B, H,
    L) fp32)."""
    if _check_inputs(q, k, v, mask, "flash_attention"):
        return flash_attention_plain(q, k, v, mask, scale)
    B, H, L, hd = q.shape
    mask = mask.contiguous()
    flags = _kernel_flags(mask, flags)
    out = torch.empty(B, H, L, hd, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, L, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _flash_lib("flash_fwd_bf16", _FWD_ARGTYPES)(
        q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
        v.data_ptr(), *v.stride()[:3], mask.data_ptr(), flags.data_ptr(), out.data_ptr(),
        lse.data_ptr(),
        B, H, L, float(_scale_in(torch.bfloat16, scale)), stream)
    _build.check(err, "flash_attention launch")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                        g: torch.Tensor, scale: float, flags: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention` (kernel K4: a dq pass and a dk/dv
    pass, launched together and counted as one launch). out and lse are the
    forward's; g, the cotangent of out, may have any strides with dense rows;
    flags as for `flash_attention`."""
    if _check_inputs(q, k, v, mask, "flash_attention_bwd"):
        return flash_attention_bwd_plain(q, k, v, mask, out, lse, g, scale)
    B, H, L, hd = q.shape
    _check_operand("g", g, tuple(q.shape), q.device)
    if lse.shape != (B, H, L) or lse.dtype != torch.float32 or out.shape != q.shape:
        raise ValueError("flash_attention_bwd: out and lse must be the forward's")
    mask, lse = mask.contiguous(), lse.contiguous()
    flags = _kernel_flags(mask, flags)
    # D = rowsum(dO * out) in fp32, once for both passes (plain tensor code
    # in the JAX package too)
    dsum = (g.float() * out.float()).sum(dim=-1)
    dq, dk, dv = (torch.empty(B, H, L, hd, dtype=q.dtype, device=q.device) for _ in range(3))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _flash_lib("flash_bwd_bf16", _BWD_ARGTYPES)(
        q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
        v.data_ptr(), *v.stride()[:3], g.data_ptr(), *g.stride()[:3],
        mask.data_ptr(), flags.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, L, float(_scale_in(torch.bfloat16, scale)), stream)
    _build.check(err, "flash_attention_bwd launch")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def _dense_rows(t: torch.Tensor) -> torch.Tensor:
    """t itself when the kernels can read it through its strides, else a
    contiguous copy."""
    if t.stride(-1) == 1 and not any(s % 8 for s in t.stride()[:-1]) and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous()


class FlashMHA(torch.autograd.Function):
    """Differentiable masked attention (the port of the JAX package's
    `flash_mha` custom_vjp): K3 forward, saving (q, k, v, mask, flags, out,
    lse), and K4 backward on CUDA tensors; the two plain versions on CPU
    tensors. Arguments (q, k, v, mask, scale, flags=None), flags as for
    `flash_attention`."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, flags=None):
        q, k, v = _dense_rows(q), _dense_rows(k), _dense_rows(v)
        out, lse = flash_attention(q, k, v, mask, scale, flags)
        ctx.save_for_backward(q, k, v, mask, flags, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, flags, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, mask, out, lse, _dense_rows(g),
                                         ctx.scale, flags)
        return dq, dk, dv, None, None, None


flash_mha = FlashMHA.apply
