"""Attention kernels of the port: decode attention over the paired (K1),
flat (K7) and fused (K8) cache layouts, decode over [cache prefix | fresh
rows] (K5) and its in-place variant (K6), and the training flash attention
forward (K3) and backward (K4).

`decode_attention` is the port of `controlvar_tpu/ops/attention.py:
flash_decode_paired`: for one layer `li` of the (depth, B, H, L_max, hd)
cache it computes softmax(q*scale . K^T [mask -> -1e30]) . V over rows
[0, cur). On a CUDA tensor it launches the hand-written Hopper kernel
`csrc/decode_attention.cu` (a persistent grid over (q group, batch*head)
items, TMA tiles in an mbarrier ring, wgmma for both products), which reads
the cache in place and q through their strides; on a CPU tensor it takes
`decode_attention_plain`, the einsum path of the JAX package's
`_mha_decode_paired` on the per-head layout, with the TPU kernel's fp32
scores.

`decode_attention_flat` (K7, the port of `flash_decode`) computes the same
function over the flat, transposed (depth, B, H, hd, L_max) cache of
configs whose head dim is not 64 or whose head count is odd, with the
kernel `csrc/decode_flat.cu` (TMA tiles in an mbarrier ring, wgmma for
both products; instances for hd = 16, 32, ..., 128);
`decode_attention_fused` (K8, the port of `flash_decode_fused`) over one
fused (depth, B, H, L_max, 2 hd) cache with rows [k_h | v_h], with the
second instance of `csrc/decode_attention.cu`'s kernel (only the tile load
differs), bit for bit K1's output. Their plain versions are K1's on the
transposed views and on the column halves.

`decode_attention_prefix` (K5, the port of `flash_decode_prefix`) attends
over a prefix read through strides and the scale's fresh rows, for the
segmented cache mode; `decode_attention_inplace` (K6, the port of
`flash_decode_inplace`) also writes the fresh rows into the stacked cache.
Both launch `csrc/decode_prefix.cu` on CUDA tensors (K5 its mma.sync kernel,
K6 its TMA/wgmma kernel, which also stores the fresh rows by TMA); on CPU
tensors they take `decode_attention_prefix_plain` (and, for K6, the write as
a tensor copy). Their rounding points are the TPU prefix kernel's, not K1's.

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
_ROWS = [_C] + [ctypes.c_longlong] * 3  # a pointer and its (batch, head, row) strides
_ARGTYPES = _ROWS + [_C] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6 + [
    ctypes.c_float, _C]


def _entry(lib: str, name: str, argtypes):
    """The C entry `name` of csrc/<lib>.cu, built and typed at first use."""
    fn = getattr(_build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
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


def _check_decode_q(what: str, q: torch.Tensor, head_dims) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.dim() != 4 or q.dtype != torch.bfloat16 or q.shape[3] not in head_dims:
        raise ValueError(f"{what}: the kernel takes (B, H, l, hd) bf16 q with hd in "
                         f"{head_dims}, got {q.dtype} {tuple(q.shape)}")


def _check_grid(what: str, B: int, H: int) -> None:
    """K6 and K7 run one grid row per (batch, head); K1 and K8, on a
    persistent grid, have no such limit."""
    if B * H > 65535:
        raise ValueError(f"{what}: B * H = {B * H} is above the grid's 65535 rows")


def _check_cache(what: str, name: str, t: torch.Tensor, shape, device) -> None:
    """A 5-D bf16 (depth, *shape, ...) cache on `device` whose rows are
    dense and start 16-byte aligned."""
    if (t.device != device or t.dtype != torch.bfloat16 or t.dim() != 5
            or tuple(t.shape[1:1 + len(shape)]) != shape):
        dims = ", ".join(map(str, shape))
        raise ValueError(f"{what}: {name} must be a 5-D bf16 (depth, {dims}, ...) tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if t.stride(4) != 1 or any(s % 8 for s in t.stride()[:4]) or t.data_ptr() % 16:
        raise ValueError(f"{what}: {name} rows must be dense and 16-byte aligned, got "
                         f"strides {t.stride()}")


def _check_mask(what: str, mask: Optional[torch.Tensor], l: int, cur: int, device):
    if mask is None:
        return None
    if mask.shape != (l, cur) or mask.dtype != torch.bool or mask.device != device:
        raise ValueError(f"{what}: mask must be ({l}, {cur}) bool on {device}, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    return mask.contiguous()


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     li: int, cur: int, scale: float,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of q (B, H, l, hd) over rows [0, cur) of layer `li` of the
    stacked caches (depth, B, H, L_max, hd); mask: optional (l, cur) bool.
    On the card q may have any (batch, head, row) strides with dense,
    16-byte-aligned rows (the fused QKV's view); the result is a fresh
    contiguous (B, H, l, hd) tensor."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache_k[li, :, :, :cur],
                                      cache_v[li, :, :, :cur], scale, mask)
    what = "decode_attention"
    _check_decode_q(what, q, (64,))
    B, H, l, hd = q.shape
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        _check_cache(what, name, t, (B, H), q.device)
        if t.shape[4] != hd:
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} does not fit q "
                             f"{tuple(q.shape)}")
    if not 0 <= li < cache_k.shape[0] or not 0 < cur <= min(cache_k.shape[3],
                                                             cache_v.shape[3]):
        raise ValueError(f"{what}: li={li}, cur={cur} out of range")
    mask = _check_mask(what, mask, l, cur, q.device)
    _check_operand("q", q, tuple(q.shape), q.device, what)  # read through its strides
    out = torch.empty(B, H, l, hd, dtype=q.dtype, device=q.device)
    kl, vl = cache_k[li], cache_v[li]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry("decode_attention", "decode_attention_bf16", _ARGTYPES)(
        *_rows(q), kl.data_ptr(), vl.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        B, H, l, cur, *kl.stride()[:3], *vl.stride()[:3],
        float(_scale_in(torch.bfloat16, scale)), stream)
    _build.check(err, f"{what} launch")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


# ---------------------------------------------------------------------------
# decode over the flat (K7) and the fused (K8) cache layouts
# ---------------------------------------------------------------------------

FLAT_HEAD_DIMS = tuple(range(16, 129, 16))  # K7's instances
_FLAT_ARGTYPES = ([ctypes.c_int, _C] + [ctypes.c_longlong] * 3 + [_C] * 4 + [ctypes.c_int] * 4
                  + [ctypes.c_longlong] * 6 + [ctypes.c_float, _C])
_FUSED_ARGTYPES = _ROWS + [_C] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3 + [
    ctypes.c_float, _C]


def decode_attention_flat_plain(q: torch.Tensor, k_t: torch.Tensor, v_t: torch.Tensor,
                                scale: float, mask: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """K7's plain version: (B, H, l, hd) q over transposed (B, H, hd, Lk) K
    and V, with the TPU kernel's rounding points (q*scale rounded to q's
    dtype, fp32 scores, p normalised, then rounded, before PV), which are
    K1's: `decode_attention_plain` on the transposed views."""
    return decode_attention_plain(q, k_t.transpose(2, 3), v_t.transpose(2, 3), scale, mask)


def decode_attention_flat(q: torch.Tensor, cache_kt: torch.Tensor, cache_vt: torch.Tensor,
                          li: int, cur: int, scale: float,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of q (B, H, l, hd) over keys [0, cur) of layer `li` of the
    flat, transposed caches (depth, B, H, hd, L_max) (kernel K7; hd a
    multiple of 16 up to 128 on the card); mask: optional (l, cur) bool.
    The kernel reads the caches in place through their strides."""
    if q.device.type == "cpu":
        return decode_attention_flat_plain(q, cache_kt[li, ..., :cur], cache_vt[li, ..., :cur],
                                           scale, mask)
    what = "decode_attention_flat"
    _check_decode_q(what, q, FLAT_HEAD_DIMS)
    B, H, l, hd = q.shape
    _check_grid(what, B, H)
    for name, t in (("cache_kt", cache_kt), ("cache_vt", cache_vt)):
        _check_cache(what, name, t, (B, H, hd), q.device)
    if not 0 <= li < cache_kt.shape[0] or not 0 < cur <= min(cache_kt.shape[4],
                                                             cache_vt.shape[4]):
        raise ValueError(f"{what}: li={li}, cur={cur} out of range")
    mask = _check_mask(what, mask, l, cur, q.device)
    q = _dense_rows(q)  # read through its strides, as the fused QKV gives it
    out = torch.empty(B, H, l, hd, dtype=q.dtype, device=q.device)
    kl, vl = cache_kt[li], cache_vt[li]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry("decode_flat", "decode_flat_bf16", _FLAT_ARGTYPES)(
        hd, *_rows(q), kl.data_ptr(), vl.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        B, H, l, cur, *kl.stride()[:3], *vl.stride()[:3],
        float(_scale_in(torch.bfloat16, scale)), stream)
    _build.check(err, f"{what} launch")
    decode_attention_flat.launches += 1
    return out


decode_attention_flat.launches = 0


def decode_attention_fused_plain(q: torch.Tensor, kv: torch.Tensor, scale: float,
                                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8's plain version: q (B, H, l, hd) over fused (B, H, Lk, 2 hd) rows
    [k_h | v_h], as K1's plain version on the two column halves (the JAX
    package's `_mha_decode_fused` defers to its paired path the same way)."""
    hd = q.shape[3]
    return decode_attention_plain(q, kv[..., :hd], kv[..., hd:], scale, mask)


def decode_attention_fused(q: torch.Tensor, cache_kv: torch.Tensor, li: int, cur: int,
                           scale: float, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of q (B, H, l, 64) over rows [0, cur) of layer `li` of the
    fused cache (depth, B, H, L_max, 128), rows [k_h | v_h] (kernel K8, equal
    bit for bit to K1 over the same rows); mask: optional (l, cur) bool. q
    as for `decode_attention`."""
    if q.device.type == "cpu":
        return decode_attention_fused_plain(q, cache_kv[li, :, :, :cur], scale, mask)
    what = "decode_attention_fused"
    _check_decode_q(what, q, (64,))
    B, H, l, hd = q.shape
    _check_cache(what, "cache_kv", cache_kv, (B, H), q.device)
    if cache_kv.shape[4] != 2 * hd:
        raise ValueError(f"{what}: cache_kv rows must be [k | v] of {2 * hd}, got "
                         f"{tuple(cache_kv.shape)}")
    if not 0 <= li < cache_kv.shape[0] or not 0 < cur <= cache_kv.shape[3]:
        raise ValueError(f"{what}: li={li}, cur={cur} out of range")
    mask = _check_mask(what, mask, l, cur, q.device)
    _check_operand("q", q, tuple(q.shape), q.device, what)  # read through its strides
    out = torch.empty(B, H, l, hd, dtype=q.dtype, device=q.device)
    kv = cache_kv[li]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry("decode_attention", "decode_fused_bf16", _FUSED_ARGTYPES)(
        *_rows(q), kv.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), B, H, l, cur, *kv.stride()[:3],
        float(_scale_in(torch.bfloat16, scale)), stream)
    _build.check(err, f"{what} launch")
    decode_attention_fused.launches += 1
    return out


decode_attention_fused.launches = 0


# ---------------------------------------------------------------------------
# decode over [cache prefix | fresh rows]: K5 (prefix) and K6 (in place)
# ---------------------------------------------------------------------------

_PREFIX_ARGTYPES = _ROWS * 5 + [_C, _C] + [ctypes.c_int] * 4 + [ctypes.c_float, _C]
_INPLACE_ARGTYPES = _ROWS * 5 + [_C] + [ctypes.c_int] * 4 + [ctypes.c_float, _C]


def _rows(t: torch.Tensor):
    """A (B, H, n, hd) operand as the kernels take it: pointer and strides."""
    return (t.data_ptr(), *t.stride()[:3])


def decode_attention_prefix_plain(q: torch.Tensor, prefix_k: torch.Tensor,
                                  prefix_v: torch.Tensor, k_new: torch.Tensor,
                                  v_new: torch.Tensor, scale: float,
                                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of q (B, H, l, hd) over [prefix (B, H, pos, hd) | fresh
    (B, H, l, hd)] with the TPU prefix kernel's rounding points: fp32 scores
    from the rounded q*scale, p = exp(s - m) over both ranges, p rounded to
    q's dtype for the PV product, and the output divided by the sum of the
    unrounded p after PV. These are not K1's (which normalizes p before
    rounding it); they are K3's, so the computation is K3's plain forward
    over the concatenated keys. mask: optional (l, pos + l) bool."""
    k = torch.cat([prefix_k.to(q.dtype), k_new.to(q.dtype)], dim=2)
    v = torch.cat([prefix_v.to(q.dtype), v_new.to(q.dtype)], dim=2)
    return flash_attention_plain(q, k, v, mask, scale)[0]


def _check_prefix_inputs(what: str, q, k_new, v_new):
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.dim() != 4 or q.shape[3] != 64:
        raise ValueError(f"{what}: the kernel takes (B, H, l, 64) bf16 q, got "
                         f"{q.dtype} {tuple(q.shape)}")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        _check_operand(name, t, tuple(q.shape), q.device, what)


def decode_attention_prefix(q: torch.Tensor, prefix_k: torch.Tensor,
                            prefix_v: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, scale: float,
                            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode attention over [prefix | fresh rows] (kernel K5).

    q, k_new, v_new: (B, H, l, hd); prefix_k, prefix_v: (B, H, pos, hd),
    e.g. one layer of a concatenated cache; all may have any (batch, head,
    row) strides with dense rows. mask: optional (l, pos + l) bool, True =
    attend. Returns (B, H, l, hd) contiguous."""
    if q.device.type == "cpu":
        return decode_attention_prefix_plain(q, prefix_k, prefix_v, k_new, v_new, scale,
                                             mask)
    what = "decode_attention_prefix"
    _check_prefix_inputs(what, q, k_new, v_new)
    B, H, l, hd = q.shape
    pos = prefix_k.shape[2]
    for name, t in (("prefix_k", prefix_k), ("prefix_v", prefix_v)):
        _check_operand(name, t, (B, H, pos, hd), q.device, what)
    if mask is not None:
        if mask.shape != (l, pos + l) or mask.dtype != torch.bool or mask.device != q.device:
            raise ValueError(f"{what}: mask must be ({l}, {pos + l}) bool on {q.device}, "
                             f"got {mask.dtype} {tuple(mask.shape)}")
        mask = mask.contiguous()
    out = torch.empty(B, H, l, hd, dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry("decode_prefix", "decode_prefix_bf16", _PREFIX_ARGTYPES)(
        *_rows(q), *_rows(prefix_k), *_rows(prefix_v), *_rows(k_new), *_rows(v_new),
        None if mask is None else mask.data_ptr(), out.data_ptr(), B, H, l, pos,
        float(_scale_in(torch.bfloat16, scale)), stream)
    _build.check(err, f"{what} launch")
    decode_attention_prefix.launches += 1
    return out


decode_attention_prefix.launches = 0


def decode_attention_inplace_plain(q: torch.Tensor, cache_k: torch.Tensor,
                                   cache_v: torch.Tensor, k_new: torch.Tensor,
                                   v_new: torch.Tensor, li: int, pos: int,
                                   scale: float) -> torch.Tensor:
    """K6's plain version: the write as a tensor copy, then K5's plain
    version over rows [0, pos) of layer li and the fresh rows."""
    cur = pos + q.shape[2]
    cache_k[li, :, :, pos:cur] = k_new
    cache_v[li, :, :, pos:cur] = v_new
    return decode_attention_prefix_plain(q, cache_k[li, :, :, :pos], cache_v[li, :, :, :pos],
                                         k_new, v_new, scale)


def decode_attention_inplace(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                             k_new: torch.Tensor, v_new: torch.Tensor, li: int, pos: int,
                             scale: float) -> torch.Tensor:
    """Write the fresh rows k_new/v_new (B, H, l, hd) into rows [pos, pos +
    l) of layer li of the stacked (depth, B, H, L_max, hd) caches, in place,
    touching no other row, and return the unmasked attention of q (B, H, l,
    hd) over rows [0, pos) of that layer and the fresh rows (kernel K6; at
    pos == 0 over the fresh rows alone)."""
    if q.device.type == "cpu":
        return decode_attention_inplace_plain(q, cache_k, cache_v, k_new, v_new, li, pos,
                                              scale)
    what = "decode_attention_inplace"
    _check_prefix_inputs(what, q, k_new, v_new)
    B, H, l, hd = q.shape
    _check_grid(what, B, H)
    if cache_k.dim() != 5 or cache_k.shape != cache_v.shape:
        raise ValueError(f"{what}: cache_k {tuple(cache_k.shape)} and cache_v "
                         f"{tuple(cache_v.shape)} must be one (depth, B, H, L_max, hd) shape")
    if not 0 <= li < cache_k.shape[0] or not 0 <= pos <= cache_k.shape[3] - l:
        raise ValueError(f"{what}: li={li}, pos={pos} (l={l}) out of range")
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        _check_operand(name, t[li], (B, H, t.shape[3], hd), q.device, what)
    out = torch.empty(B, H, l, hd, dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry("decode_prefix", "decode_inplace_bf16", _INPLACE_ARGTYPES)(
        *_rows(q), *_rows(cache_k[li]), *_rows(cache_v[li]), *_rows(k_new), *_rows(v_new),
        out.data_ptr(), B, H, l, pos, float(_scale_in(torch.bfloat16, scale)), stream)
    _build.check(err, f"{what} launch")
    decode_attention_inplace.launches += 1
    return out


decode_attention_inplace.launches = 0


# ---------------------------------------------------------------------------
# training attention: K3 (forward with LSE) and K4 (backward)
# ---------------------------------------------------------------------------

_FWD_ARGTYPES = ([_C] + [ctypes.c_longlong] * 3) * 3 + [_C] * 4 + [ctypes.c_int] * 3 + [
    ctypes.c_float, _C]
_BWD_ARGTYPES = ([_C] + [ctypes.c_longlong] * 3) * 4 + [_C] * 7 + [ctypes.c_int] * 3 + [
    ctypes.c_float, _C]
_TILE = 64  # rows of the kernels' tiles


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 for bf16/fp32 inputs (the kernels' accumulators), fp64 for fp64
    (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def _scores(q: torch.Tensor, k: torch.Tensor, mask: Optional[torch.Tensor],
            scale: float) -> torch.Tensor:
    """(q*scale rounded to q's dtype) . K^T in the accumulator dtype, masked
    scores at -1e30: the TPU kernels' S, forward and backward alike."""
    acc = _acc_dtype(q.dtype)
    qs = q * _scale_in(q.dtype, scale).to(q.device)
    s = torch.einsum("bhqd,bhkd->bhqk", qs.to(acc), k.to(acc))
    return s if mask is None else torch.where(mask, s, NEG_INF)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor], scale: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, L, hd) q, k, v and an (L, L) bool mask -> (out (B, H, L, hd) in
    q's dtype, lse (B, H, L) fp32); with q of l < L rows the mask is (l, L),
    and None leaves the scores unmasked. Scores, softmax sums and the PV product
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


def _check_operand(name: str, t: torch.Tensor, shape, device,
                   what: str = "flash attention") -> None:
    if t.device != device or t.dtype != torch.bfloat16 or tuple(t.shape) != shape:
        raise ValueError(f"{what}: {name} must be a bf16 {shape} tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{what}: {name} rows must be dense and 16-byte "
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
    err = _entry("flash_attention", "flash_fwd_bf16", _FWD_ARGTYPES)(
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
    err = _entry("flash_attention", "flash_bwd_bf16", _BWD_ARGTYPES)(
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
