"""Sort-free top-k / top-p sampling: per-row bisection + gumbel-max (kernel K2).

`sample_top_k_top_p_bisect` is the port of `controlvar_tpu/ops/sample_kernel.py:
sample_top_k_top_p_bisect`. The filter replaces order statistics by
bisection on the two monotone step functions the filters need:
  top-k: count(l >= t)                 -> the k-th largest value
  top-p: kept softmax mass strictly above v -> the nucleus boundary (the
         crossing token is kept)
then draws by gumbel-max over the kept set, which is a categorical over the
kept logits. Entries more than TAIL_NATS below the row max are never kept.

On a CUDA tensor it launches `csrc/sample_bisect.cu`, which reaches the same
thresholds without the 52 reductions: the top-k test count(l >= mid) >= k
holds exactly when the k-th largest logit is >= mid, and the top-p test
holds exactly when mid lies below the largest logit whose mass at or above
it reaches top_p * Z, so it finds those two values by selection (an exact
integer histogram over bins of the value range, then the crossing bin's
entries ranked) and replays the 26 midpoints against them. The top-k threshold is the
bisection's bit for bit; the top-p mass is summed exactly (in fixed point),
where the plain version sums fp32 in its own order, so a row whose crossing
that order moves may keep one token more or less. The noise is either an
(n, V) fp32 input, or made by the kernel's own Philox from two seed words
drawn from the caller's CPU `torch.Generator` (the main path). On a CPU
tensor it takes `sample_bisect_plain`: `kept_mask_plain` plus gumbel-max.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from controlvar_tpu_torch.ops import _build

NEG_INF = -1e30
TAIL_NATS = 80.0
N_ITER = 26  # bisection steps per filter: the interval shrinks by 2^-26
MAX_VOCAB = 4096  # 256 threads x 16 register-resident values per row

_C = ctypes.c_void_p
_ARGTYPES = [_C, _C, _C] + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_uint32,
                                                   ctypes.c_uint32, _C]


def _lib():
    fn = _build.load("sample_bisect").sample_bisect_f32
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def kept_mask_plain(l: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """The bisection filter: bool kept set of fp32 logits (R, V)."""
    V = l.shape[-1]
    m = l.max(dim=-1, keepdim=True).values
    lo0 = m - TAIL_NATS
    kept = l >= lo0
    if 0 < top_k < V:
        # invariant: count(l >= lo) >= k, count(l >= hi) < k
        lo, hi = lo0, m + 1.0
        for _ in range(N_ITER):
            mid = 0.5 * (lo + hi)
            ge = (l >= mid).float().sum(dim=-1, keepdim=True) >= top_k
            lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
        kept = l >= lo
    if top_p > 0.0:
        e = torch.where(kept, torch.exp(l - m), 0.0)
        pz = top_p * e.sum(dim=-1, keepdim=True)
        lo, hi = lo0, m + 1.0
        for _ in range(N_ITER):
            mid = 0.5 * (lo + hi)
            ge = torch.where(l > mid, e, 0.0).sum(dim=-1, keepdim=True) >= pz
            lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
        kept = kept & (l > lo)
    return kept


def seed_words(generator: Optional[torch.Generator]) -> tuple:
    """Two 32-bit seed words drawn from the caller's CPU generator."""
    return tuple(int(w) for w in torch.randint(0, 1 << 32, (2,), generator=generator))


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """Gumbel noise from 23 random bits, as the kernel's Philox path makes it:
    u = (x23 + 0.5) * 2^-23, g = -log(-log(u)). On the CPU it is drawn from
    `generator`; on another device, by a generator of that device seeded
    from two words of `generator`, so the noise never crosses the bus."""
    device = torch.device(device)
    if device.type != "cpu":
        s0, s1 = seed_words(generator)
        generator = torch.Generator(device=device).manual_seed((s0 << 32) | s1)
    x23 = torch.randint(0, 1 << 23, shape, generator=generator, dtype=torch.int32,
                        device=device)
    u = (x23.float() + 0.5) * (1.0 / (1 << 23))
    return -torch.log(-torch.log(u))


def sample_bisect_plain(l: torch.Tensor, g: torch.Tensor, top_k: int,
                        top_p: float) -> torch.Tensor:
    """ids (R,) = argmax over the kept set of l + g (first index on ties)."""
    kept = kept_mask_plain(l, top_k, top_p)
    return torch.argmax(torch.where(kept, l + g, NEG_INF), dim=-1)


def sample_top_k_top_p_bisect(logits: torch.Tensor, top_k: int = 0,
                              top_p: float = 0.0,
                              generator: Optional[torch.Generator] = None,
                              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Draw ids (...,) int64 from top-k/top-p filtered logits (..., V).

    noise: optional gumbel noise of logits' shape; without it the CPU path
    draws noise from `generator` and the kernel seeds its Philox from it."""
    *lead, V = logits.shape
    lf = logits.reshape(-1, V)
    if noise is not None:
        noise = noise.reshape(lf.shape)
    if logits.device.type == "cpu":
        lf = lf.float()
        g = gumbel_noise(lf.shape, generator) if noise is None else noise.float()
        return sample_bisect_plain(lf, g, top_k, top_p).reshape(lead)
    if logits.device.type != "cuda":
        raise ValueError(f"sample_top_k_top_p_bisect: unsupported device {logits.device}")
    if logits.dtype != torch.float32 or not 0 < V <= MAX_VOCAB or lf.shape[0] == 0:
        raise ValueError(f"sample_top_k_top_p_bisect: the kernel takes fp32 rows "
                         f"of at most {MAX_VOCAB} logits, got {logits.dtype} "
                         f"{tuple(logits.shape)}")
    lf = lf.contiguous()
    if noise is None:
        s0, s1 = seed_words(generator)
        noise_ptr = None
    else:
        if noise.dtype != torch.float32 or noise.device != logits.device:
            raise ValueError("sample_top_k_top_p_bisect: noise must be fp32 on "
                             f"{logits.device}")
        noise = noise.contiguous()
        s0 = s1 = 0
        noise_ptr = noise.data_ptr()
    out = torch.empty(lf.shape[0], dtype=torch.int64, device=logits.device)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    err = _lib()(lf.data_ptr(), noise_ptr, out.data_ptr(), lf.shape[0], V,
                 int(top_k), float(top_p), s0, s1, stream)
    _build.check(err, "sample_bisect launch")
    sample_top_k_top_p_bisect.launches += 1
    return out.reshape(lead)


sample_top_k_top_p_bisect.launches = 0
