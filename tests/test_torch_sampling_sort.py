"""The port's sort route of the sampler against the JAX package's.

The filters are deterministic: `top_k_top_p_filter` and
`filtered_sorted_logits` must be bit-equal to the JAX functions on the same
numpy logits, ties included (a stable sort puts the lower index first among
equal keys, as `lax.top_k` and `jnp.argsort` do; `lax.top_k` also ranks +0
above -0, and the rows rounded to a grid hold both). The logits are checked to
lie off the nucleus boundary, where the two frameworks' fp32 cumsums could
round to either side. The draws use another random stream than JAX's, so
the sort route's draws and `gumbel_softmax` are checked by distribution
against the analytic probabilities: the empirical total-variation distance
of 1e4 draws within twice the multinomial noise, as
tests/test_sampling_stats.py holds the JAX sampler."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from controlvar_tpu.ops import sampling as jsampling

from controlvar_tpu_torch.ops.sample_kernel import sample_top_k_top_p_bisect
from controlvar_tpu_torch.ops.sampling import (filtered_sorted_logits, gumbel_softmax,
                                               sample_top_k_top_p, top_k_top_p_filter)

from tests.torch_fixtures import one_torch_thread  # noqa: F401

V = 512
N_DRAWS = 10_000


def _logits(seed: int, rows: int = 6) -> np.ndarray:
    """Peaked rows with exact ties (values on a 1/8 grid) and rows of
    distinct values."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, (rows, V)).astype(np.float32)
    x[: rows // 2] = np.round(x[: rows // 2] * 8) / 8
    x[:, :4] += 4.0
    return x


def _margin(x: np.ndarray, top_k: int, top_p: float, key_dtype) -> float:
    """The least distance of a cumulative probability of the top-k kept
    keys from top_p's boundary. The descending form keeps j while cum_j -
    p_j < top_p; the ascending form drops j while its cumulative sum,
    1 - (cum_j - p_j), is <= 1 - top_p: both decide on the same quantity."""
    if top_p <= 0.0:
        return np.inf
    keys = np.asarray(jnp.asarray(x).astype(key_dtype).astype(jnp.float32), np.float64)
    vals = -np.sort(-keys, axis=-1)
    if top_k > 0:
        vals = np.where(vals >= vals[:, top_k - 1: top_k], vals, -np.inf)
    p = np.exp(vals - vals[:, :1])
    p /= p.sum(-1, keepdims=True)
    return float(np.abs(np.cumsum(p, -1) - p - top_p).min())


def _off_boundary_logits(seed: int, top_k: int, top_p: float, key_dtype) -> np.ndarray:
    """The first logits from seed on whose margin is 2e-5 or more (an fp32
    cumsum over 512 terms is off by ~1e-6), so no ulp flips a kept entry."""
    for s in range(seed, seed + 100):
        x = _logits(s)
        if _margin(x, top_k, top_p, key_dtype) >= 2e-5:
            return x
    raise AssertionError("no logits off the nucleus boundary")


@pytest.mark.parametrize("top_k,top_p", [(10, 0.0), (0, 0.9), (37, 0.8), (200, 0.96)])
def test_filter_bit_equal_to_jax(top_k, top_p):
    x = _off_boundary_logits(top_k, top_k, top_p, jnp.float32)
    want = np.asarray(jsampling.top_k_top_p_filter(jnp.asarray(x), top_k, top_p))
    got = top_k_top_p_filter(torch.from_numpy(x), top_k, top_p).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == jsampling.NEG_INF).any() and (got != jsampling.NEG_INF).any()


@pytest.mark.parametrize("top_k,top_p", [(1, 0.0), (10, 0.9), (64, 0.0), (65, 0.9),
                                         (300, 0.96), (0, 0.9)])
def test_filtered_sorted_logits_bit_equal_to_jax(top_k, top_p):
    """Values and vocab ids, for the exact fp32 selection (top_k <= 64) and
    the bf16 keys (top_k > 64), where rounding makes many ties."""
    x = _off_boundary_logits(top_k + 1, top_k, top_p,
                             jnp.bfloat16 if top_k > 64 else jnp.float32)
    jv, ji = jsampling.filtered_sorted_logits(jnp.asarray(x), top_k, top_p)
    tv, ti = filtered_sorted_logits(torch.from_numpy(x), top_k, top_p)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _tv_check(draws: np.ndarray, p: np.ndarray) -> None:
    emp = np.bincount(draws, minlength=p.size) / draws.size
    tv = 0.5 * np.abs(emp - p).sum()
    noise = 0.5 * np.sqrt(p * (1 - p) / draws.size).sum()
    assert tv < 2.0 * noise + 1e-3, (tv, noise)


@pytest.mark.parametrize("top_k,top_p", [(900, 0.96), (40, 0.0), (0, 0.8)])
def test_sort_draws_match_analytic_distribution(top_k, top_p):
    """1e4 draws of the sort route from one row: every draw kept, and the
    draws distributed as the softmax over the kept sorted values."""
    x = _logits(3, rows=1)[0] / 2
    vals, idx = filtered_sorted_logits(torch.from_numpy(x)[None], top_k, top_p)
    p = np.zeros(V)
    p[idx[0].numpy()] = torch.softmax(vals[0].double(), -1).numpy()
    draws = sample_top_k_top_p(torch.from_numpy(x).expand(N_DRAWS, V), top_k, top_p,
                               torch.Generator().manual_seed(top_k), method="sort").numpy()
    assert p[draws].min() > 0.0
    _tv_check(draws, p)


def test_methods_and_greedy():
    """The bisect names take K2's route (its plain version here), the sort
    route's greedy draw is the argmax, and an unknown method raises."""
    x = torch.from_numpy(_logits(9))
    for method in ("auto", "bisect", "bisect_prng"):
        got = sample_top_k_top_p(x, 50, 0.9, torch.Generator().manual_seed(1), method=method)
        want = sample_top_k_top_p_bisect(x, 50, 0.9, generator=torch.Generator().manual_seed(1))
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    greedy = sample_top_k_top_p(x + torch.arange(V) * 1e-6, 1, 0.0, torch.Generator(),
                                method="sort")
    torch.testing.assert_close(greedy, (x + torch.arange(V) * 1e-6).argmax(-1))
    with pytest.raises(ValueError, match="unknown sampling method"):
        sample_top_k_top_p(x, 5, 0.0, torch.Generator(), method="topk")


@pytest.mark.parametrize("tau", [0.5, 2.0])
def test_gumbel_softmax_distribution(tau):
    """The argmax of a gumbel-softmax sample is distributed as
    softmax(logits) at any temperature; soft samples sum to 1; the hard
    sample is that one-hot with the soft sample's gradient."""
    x = torch.from_numpy(_logits(4, rows=1)[0] / 3).requires_grad_(True)
    soft = gumbel_softmax(x.expand(N_DRAWS, V), tau, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(soft.sum(-1), torch.ones(N_DRAWS), rtol=0, atol=1e-5)
    _tv_check(soft.argmax(-1).numpy(), torch.softmax(x.double(), -1).detach().numpy())

    gen = lambda: torch.Generator().manual_seed(5)
    hard = gumbel_softmax(x[None], tau, hard=True, generator=gen())
    soft1 = gumbel_softmax(x[None], tau, generator=gen())
    torch.testing.assert_close(hard.detach(), torch.nn.functional.one_hot(
        soft1.argmax(-1), V).float(), rtol=0, atol=1e-6)
    w = torch.randn(V, generator=torch.Generator().manual_seed(6))
    g_hard, = torch.autograd.grad((hard * w).sum(), x)
    g_soft, = torch.autograd.grad((soft1 * w).sum(), x)
    torch.testing.assert_close(g_hard, g_soft)
