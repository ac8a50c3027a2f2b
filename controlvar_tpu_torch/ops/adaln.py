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

The backward of each site (`*_bwd_plain`, and `csrc/adaln.cu`'s backward
kernels) is the closed form of the kernel's forward, with x^ = (h - mu)
rstd: for `adaln_norm`, with u = dhn (1 + s),
  dh = rstd (u - mean_C(u) - x^ mean_C(u x^)), ds = sum_l dhn x^, dsh = sum_l dhn;
for `adaln_add_norm`, t = dh' + (that LN backward of dhn through h'),
  dh = t, dy = t g keep, dg = keep sum_l t (y + b), db = sum_b g keep sum_l t,
  and ds, dsh as for `adaln_norm`;
for `adaln_add`, dh = dout (as is), df = dout g keep, dg and db as above.
A (1, 1, C) row's gradient sums over the batch too. Every sum is fp32 (or
float64 for float64 inputs); a row's and the bias's gradient come back in
their own dtypes, h's and y's in theirs. keep gets none.

Dispatch, by what the inputs show: the plain version for CPU tensors; for
CUDA tensors under autograd with an input that requires grad (the train
step, LoRA, the Trainer, every remat policy), a `torch.autograd.Function`
whose forward is the kernel and whose backward the backward kernel;
otherwise the kernel, called directly. A CUDA input the kernels do not take
raises, as does any other device: nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from controlvar_tpu_torch.ops import _build

MAX_WIDTH = 8192                      # C: 8 columns a thread, 1024 threads a block

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_C, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "adaln_norm": [_I, _C, _C, _C, _LL, _C, _I, _I, _I, ctypes.c_float, _C],
    "adaln_add_norm": [_I, _I, _C, _C, _C, _C, _C, _C, _LL, _C, _C, _C, _I, _I, _I,
                       ctypes.c_float, _C],
    "adaln_add": [_I, _I, _C, _C, _C, _C, _LL, _C, _C, _I, _I, _I, _C],
    "adaln_norm_bwd": [_I, _C, _C, _LL, _C, _C, _C, _C, _C, _I, _I, _I, _I, ctypes.c_float,
                       _C],
    "adaln_add_norm_bwd": [_I, _I, _C, _C, _C, _C, _C, _LL, _C, _C, _C, _C, _C, _C, _C, _C,
                           _C, _C, _I, _I, _I, _I, ctypes.c_float, _C],
    "adaln_add_bwd": [_I, _I, _C, _C, _C, _LL, _C, _C, _C, _C, _C, _C, _I, _I, _I, _I, _C],
    "adaln_bwd_capacity": [_I, _I, _I, _I],
}
_BWD_SITES = {"adaln_norm": 0, "adaln_add_norm": 1, "adaln_add": 2}


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


# ---- the plain backward: the closed form, in fp32 (float64 for float64 inputs) --

def _acc_dtype(*tensors) -> torch.dtype:
    return (torch.float64 if any(t is not None and t.dtype == torch.float64 for t in tensors)
            else torch.float32)


def _keep3(keep, acc):
    return 1.0 if keep is None else keep.to(acc).reshape(-1, 1, 1)


def _row_sum(t: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """sum_l of t (B, l, C), as row's (B or 1, 1, C) in row's dtype."""
    s = t.sum(dim=1, keepdim=True)
    if row.shape[0] == 1:
        s = s.sum(dim=0, keepdim=True)
    return s.to(row.dtype)


def _ln_bwd_plain(x, scale, dhn, eps):
    """The LN-and-modulation backward at x (acc dtype): (dx, x^)."""
    x = x - x.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    xh = x * rstd
    u = dhn * (scale.to(x.dtype) + 1.0)
    dx = rstd * (u - u.mean(dim=-1, keepdim=True)
                 - xh * (u * xh).mean(dim=-1, keepdim=True))
    return dx, xh


def _branch_bwd_plain(t, v, bias, gate, keep, acc, need_y, y_dtype, need_bias, need_gate):
    """dy, dbias, dgate of the gated branch g (v) keep, v = y + b, from t."""
    gk = gate.to(acc) * _keep3(keep, acc)
    dy = (t * gk).to(y_dtype) if need_y else None
    dbias = (t * gk).sum(dim=(0, 1)).to(bias.dtype) if need_bias else None
    dgate = None
    if need_gate:
        dgate = _row_sum(t * v * _keep3(keep, acc), gate)
    return dy, dbias, dgate


def adaln_norm_bwd_plain(h: torch.Tensor, scale: torch.Tensor, dhn: torch.Tensor, eps: float,
                         needs=(True, True, True)):
    """(dh, dscale, dshift) of `adaln_norm` (module docstring); None where
    `needs` (h, scale, shift) does not ask."""
    acc = _acc_dtype(h, scale, dhn)
    need_h, need_scale, need_shift = needs
    d = dhn.to(acc)
    dx, xh = _ln_bwd_plain(h.to(acc), scale, d, eps)
    return (dx.to(h.dtype) if need_h else None,
            _row_sum(d * xh, scale) if need_scale else None,
            _row_sum(d, scale) if need_shift else None)


def adaln_add_norm_bwd_plain(h: torch.Tensor, y: torch.Tensor, bias: torch.Tensor,
                             gate: torch.Tensor, scale: torch.Tensor, dh_out: torch.Tensor,
                             dhn: torch.Tensor, eps: float, keep: Optional[torch.Tensor] = None,
                             needs=(True,) * 6):
    """(dh, dy, dbias, dgate, dscale, dshift) of `adaln_add_norm`, from the
    gradients of its two outputs; None where `needs` (h, y, bias, gate,
    scale, shift) does not ask."""
    acc = _acc_dtype(h, y, bias, gate, dh_out, dhn)
    need_h, need_y, need_bias, need_gate, need_scale, need_shift = needs
    v = y.to(acc) + bias.to(y.dtype).to(acc)
    x = h.to(acc) + v * gate.to(acc) * _keep3(keep, acc)
    d = dhn.to(acc)
    dx, xh = _ln_bwd_plain(x, scale, d, eps)
    t = dh_out.to(acc) + dx
    dy, dbias, dgate = _branch_bwd_plain(t, v, bias, gate, keep, acc, need_y, y.dtype,
                                         need_bias, need_gate)
    return (t.to(h.dtype) if need_h else None, dy, dbias, dgate,
            _row_sum(d * xh, scale) if need_scale else None,
            _row_sum(d, scale) if need_shift else None)


def adaln_add_bwd_plain(f: torch.Tensor, bias: torch.Tensor, gate: torch.Tensor,
                        dout: torch.Tensor, keep: Optional[torch.Tensor] = None,
                        needs=(True,) * 4):
    """(dh, df, dbias, dgate) of `adaln_add`, dh being dout itself; None
    where `needs` (h, f, bias, gate) does not ask."""
    acc = _acc_dtype(f, bias, gate, dout)
    need_h, need_f, need_bias, need_gate = needs
    v = f.to(acc) + bias.to(f.dtype).to(acc)
    df, dbias, dgate = _branch_bwd_plain(dout.to(acc), v, bias, gate, keep, acc, need_f,
                                         f.dtype, need_bias, need_gate)
    return dout if need_h else None, df, dbias, dgate


def _route(*tensors) -> str:
    """"plain", "function" or "kernel": how a site runs on these inputs
    (module docstring)."""
    if tensors[0].device.type == "cpu":
        return "plain"
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        return "function"
    return "kernel"


def _no_keep_grad(what, route, keep):
    if route == "function" and keep is not None and keep.requires_grad:
        raise ValueError(f"{what}: keep gets no gradient from the kernels")


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it, dense and starting 16-byte aligned."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _residual(what, h):
    """h checked: (B, l, C) bf16 or fp32 on a CUDA device, dense."""
    if h.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {h.device}")
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


def _grad(what, h, g):
    """An output's gradient checked against h: the same shape and dtype, dense."""
    if g.shape != h.shape or g.dtype != h.dtype or g.device != h.device:
        raise ValueError(f"{what}: a gradient must be {h.dtype} {tuple(h.shape)} on "
                         f"{h.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    return _dense(g)


_capacity = {}


def _bwd_tokens(what: str, h: torch.Tensor, y: Optional[torch.Tensor]) -> int:
    """Tokens a backward block: the fewest that fit the grid of B x
    ceil(l / T) blocks in one wave of the blocks the device holds at once
    (`adaln_bwd_capacity`, cached per kernel and device)."""
    B, l, C = h.shape
    key = (what, h.dtype, (h if y is None else y).dtype, C, h.device)
    cap = _capacity.get(key)
    if cap is None:
        cap = _entry("adaln_bwd_capacity")(_BWD_SITES[what], _DTYPES[key[1]], _DTYPES[key[2]],
                                           C)
        _build.check(max(-cap, 0), f"{what} backward occupancy")
        _capacity[key] = cap
    return -(-l // max(1, cap // B))


def _partials(n: int, h: torch.Tensor, T: int, wanted: bool) -> Optional[torch.Tensor]:
    """The backward's (n, B, ceil(l / T), C) fp32 column-sum partials, or None
    where no row or bias gradient is asked for."""
    B, l, C = h.shape
    return (torch.empty(n, B, -(-l // T), C, dtype=torch.float32, device=h.device)
            if wanted else None)


def _row_grad(row: torch.Tensor, wanted: bool) -> Optional[torch.Tensor]:
    return torch.empty(row.shape, dtype=torch.float32, device=row.device) if wanted else None


def _norm_kernel(h, scale, shift, eps):
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


def _norm_bwd_kernel(h, scale, dhn, eps, needs=(True, True, True)):
    """`adaln_norm_bwd_plain` on the card."""
    what = "adaln_norm backward"
    h = _residual(what, h)
    dhn = _grad(what, h, dhn)
    (scale_in,), sb = _rows(what, h, scale)
    B, l, C = h.shape
    T = _bwd_tokens("adaln_norm", h, None)
    dh = torch.empty_like(h) if needs[0] else None
    dscale, dshift = _row_grad(scale, needs[1]), _row_grad(scale, needs[2])
    part = _partials(2, h, T, needs[1] or needs[2])
    err = _entry("adaln_norm_bwd")(_DTYPES[h.dtype], h.data_ptr(), scale_in.data_ptr(), sb,
                                   dhn.data_ptr(), _ptr(dh), _ptr(part), _ptr(dscale),
                                   _ptr(dshift), B, l, C, T, float(eps), _stream(h))
    _build.check(err, "adaln_norm backward launch")
    adaln_norm.bwd_launches += 1
    return dh, dscale, dshift


def _add_norm_kernel(h, y, bias, gate, scale, shift, eps, keep=None):
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


def _add_norm_bwd_kernel(h, y, bias, gate, scale, dh_out, dhn, eps, keep=None,
                         needs=(True,) * 6):
    """`adaln_add_norm_bwd_plain` on the card."""
    what = "adaln_add_norm backward"
    h = _residual(what, h)
    dh_out, dhn = _grad(what, h, dh_out), _grad(what, h, dhn)
    (gate_in, scale_in), sb = _rows(what, h, gate, scale)
    y, bias_y, keep = _branch(what, h, y, bias, keep)
    B, l, C = h.shape
    T = _bwd_tokens("adaln_add_norm", h, y)
    need_h, need_y, need_bias, need_gate, need_scale, need_shift = needs
    dh = torch.empty_like(h) if need_h else None
    dy = torch.empty_like(y) if need_y else None
    dgate, dscale, dshift = (_row_grad(gate, need_gate), _row_grad(scale, need_scale),
                             _row_grad(scale, need_shift))
    dbias = torch.empty(C, dtype=torch.float32, device=h.device) if need_bias else None
    part = _partials(4, h, T, need_bias or need_gate or need_scale or need_shift)
    err = _entry("adaln_add_norm_bwd")(
        _DTYPES[h.dtype], _DTYPES[y.dtype], h.data_ptr(), y.data_ptr(), bias_y.data_ptr(),
        gate_in.data_ptr(), scale_in.data_ptr(), sb, _ptr(keep), dh_out.data_ptr(),
        dhn.data_ptr(), _ptr(dh), _ptr(dy), _ptr(part), _ptr(dgate), _ptr(dscale),
        _ptr(dshift), _ptr(dbias), B, l, C, T, float(eps), _stream(h))
    _build.check(err, "adaln_add_norm backward launch")
    adaln_add_norm.bwd_launches += 1
    return dh, dy, None if dbias is None else dbias.to(bias.dtype), dgate, dscale, dshift


def _add_kernel(h, f, bias, gate, keep=None):
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


def _add_bwd_kernel(f, bias, gate, dout, keep=None, needs=(True,) * 4):
    """`adaln_add_bwd_plain` on the card; dh is dout itself."""
    what = "adaln_add backward"
    dout = _residual(what, dout)
    (gate_in,), sb = _rows(what, dout, gate)
    f, bias_f, keep = _branch(what, dout, f, bias, keep)
    B, l, C = dout.shape
    T = _bwd_tokens("adaln_add", dout, f)
    need_h, need_f, need_bias, need_gate = needs
    df = torch.empty_like(f) if need_f else None
    dgate = _row_grad(gate, need_gate)
    dbias = torch.empty(C, dtype=torch.float32, device=dout.device) if need_bias else None
    part = _partials(2, dout, T, need_bias or need_gate)
    err = _entry("adaln_add_bwd")(_DTYPES[dout.dtype], _DTYPES[f.dtype], f.data_ptr(),
                                  bias_f.data_ptr(), gate_in.data_ptr(), sb, _ptr(keep),
                                  dout.data_ptr(), _ptr(df), _ptr(part), _ptr(dgate),
                                  _ptr(dbias), B, l, C, T, _stream(dout))
    _build.check(err, "adaln_add backward launch")
    adaln_add.bwd_launches += 1
    return (dout if need_h else None, df, None if dbias is None else dbias.to(bias.dtype),
            dgate)


class _NormFn(torch.autograd.Function):
    """`adaln_norm` under autograd: the kernel and its backward kernel."""

    @staticmethod
    def forward(ctx, h, scale, shift, eps):
        ctx.eps = eps
        ctx.save_for_backward(h, scale)
        return _norm_kernel(h, scale, shift, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, dhn):
        h, scale = ctx.saved_tensors
        return (*_norm_bwd_kernel(h, scale, dhn, ctx.eps, ctx.needs_input_grad[:3]), None)


class _AddNormFn(torch.autograd.Function):
    """`adaln_add_norm` under autograd."""

    @staticmethod
    def forward(ctx, h, y, bias, gate, scale, shift, eps, keep):
        ctx.eps = eps
        ctx.save_for_backward(h, y, bias, gate, scale, keep)
        return _add_norm_kernel(h, y, bias, gate, scale, shift, eps, keep)

    @staticmethod
    @once_differentiable
    def backward(ctx, dh_out, dhn):
        h, y, bias, gate, scale, keep = ctx.saved_tensors
        return (*_add_norm_bwd_kernel(h, y, bias, gate, scale, dh_out, dhn, ctx.eps, keep,
                                      ctx.needs_input_grad[:6]), None, None)


class _AddFn(torch.autograd.Function):
    """`adaln_add` under autograd."""

    @staticmethod
    def forward(ctx, h, f, bias, gate, keep):
        ctx.save_for_backward(f, bias, gate, keep)
        return _add_kernel(h, f, bias, gate, keep)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        f, bias, gate, keep = ctx.saved_tensors
        return (*_add_bwd_kernel(f, bias, gate, dout, keep, ctx.needs_input_grad[:4]), None)


def adaln_norm(h: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
               eps: float) -> torch.Tensor:
    """The attention's input: LN(h) (1 + scale) + shift in h's dtype."""
    route = _route(h, scale, shift)
    if route == "plain":
        return adaln_norm_plain(h, scale, shift, eps)
    if route == "function":
        return _NormFn.apply(h, scale, shift, eps)
    return _norm_kernel(h, scale, shift, eps)


def adaln_add_norm(h: torch.Tensor, y: torch.Tensor, bias: torch.Tensor, gate: torch.Tensor,
                   scale: torch.Tensor, shift: torch.Tensor, eps: float,
                   keep: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention branch's gated residual h' = h + gate (y + bias) keep
    and the FFN's input LN(h') (1 + scale) + shift, both in h's dtype."""
    route = _route(h, y, bias, gate, scale, shift, keep)
    if route == "plain":
        return adaln_add_norm_plain(h, y, bias, gate, scale, shift, eps, keep)
    _no_keep_grad("adaln_add_norm", route, keep)
    if route == "function":
        return _AddNormFn.apply(h, y, bias, gate, scale, shift, eps, keep)
    return _add_norm_kernel(h, y, bias, gate, scale, shift, eps, keep)


def adaln_add(h: torch.Tensor, f: torch.Tensor, bias: torch.Tensor, gate: torch.Tensor,
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The FFN branch's gated residual h + gate (f + bias) keep in h's dtype."""
    route = _route(h, f, bias, gate, keep)
    if route == "plain":
        return adaln_add_plain(h, f, bias, gate, keep)
    _no_keep_grad("adaln_add", route, keep)
    if route == "function":
        return _AddFn.apply(h, f, bias, gate, keep)
    return _add_kernel(h, f, bias, gate, keep)


adaln_norm.launches = adaln_add_norm.launches = adaln_add.launches = 0
adaln_norm.bwd_launches = adaln_add_norm.bwd_launches = adaln_add.bwd_launches = 0
