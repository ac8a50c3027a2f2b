"""The port's bisection sampler (kernel K2's plain version and its CPU
dispatch) against the JAX package's `kept_mask` and interpret-mode kernel."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlvar_tpu.ops.sample_kernel import kept_mask, sample_top_k_top_p_bisect as j_bisect

from controlvar_tpu_torch.ops.sample_kernel import (
    N_ITER, TAIL_NATS, gumbel_noise, kept_mask_plain, sample_bisect_plain,
    sample_top_k_top_p_bisect)
from controlvar_tpu_torch.ops.sampling import sample_top_k_top_p

from tests.torch_fixtures import one_torch_thread  # noqa: F401


def _separated_logits(V, seed):
    """Rows with no two values within the bisection resolution (80/2^26)."""
    rng = np.random.default_rng(seed)
    base = rng.permutation(V).astype(np.float32) * (8.0 / V)
    l = np.stack([base, base[::-1].copy(), rng.permutation(base)])
    return l + rng.normal(0, 1e-3, l.shape).astype(np.float32)


@pytest.mark.parametrize("top_k,top_p,V", [(8, 0.0, 64), (0, 0.9, 64), (8, 0.9, 64),
                                           (900, 0.96, 4096)])
def test_kept_mask_equals_jax(top_k, top_p, V):
    l = _separated_logits(V, 0)
    want = np.asarray(kept_mask(jnp.asarray(l), top_k, top_p, n_iter=26))
    got = kept_mask_plain(torch.from_numpy(l), top_k, top_p).numpy()
    np.testing.assert_array_equal(got, want)


def test_draw_equals_jax_kernel_on_same_noise():
    """Fed the JAX kernel's own gumbel noise, the plain draw picks the same
    ids as the interpret-mode Pallas kernel (16 rows, V=256: no padding)."""
    rng = np.random.default_rng(1)
    l = rng.normal(0, 3.0, (16, 256)).astype(np.float32)
    key = jax.random.key(5)
    want = j_bisect(key, jnp.asarray(l), 32, 0.9, interpret=True)
    g = np.array(jax.random.gumbel(key, l.shape, jnp.float32))
    got = sample_bisect_plain(torch.from_numpy(l), torch.from_numpy(g), 32, 0.9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    noise_in = sample_top_k_top_p_bisect(torch.from_numpy(l), 32, 0.9,
                                         noise=torch.from_numpy(g))
    np.testing.assert_array_equal(noise_in.numpy(), np.asarray(want))


def test_greedy_draws_equal_argmax():
    l = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (4, 7, 4096))
                         .astype(np.float32))
    ids = sample_top_k_top_p(l, 1, 0.0, torch.Generator().manual_seed(0))
    assert ids.shape == (4, 7) and ids.dtype == torch.int64
    torch.testing.assert_close(ids, l.argmax(-1), rtol=0, atol=0)


def test_draw_distribution_within_multinomial_noise():
    """1e4 draws of the realistic-scale row vs the analytic filtered softmax:
    the empirical TV distance must be consistent with multinomial noise
    (within 2x of E[TV] <= 0.5 * sum sqrt(p(1-p)/n), as for the JAX path)."""
    V, top_k, top_p, n = 4096, 900, 0.96, 10_000
    row = (np.random.default_rng(3).normal(0, 4, V) / 4.0).astype(np.float32)
    kept = kept_mask_plain(torch.from_numpy(row[None]), top_k, top_p)[0].numpy()
    e = np.where(kept, np.exp(row - row.max()), 0.0)
    p = e / e.sum()
    draws = sample_top_k_top_p_bisect(torch.from_numpy(np.tile(row, (n, 1))), top_k,
                                      top_p, generator=torch.Generator().manual_seed(1))
    emp = np.bincount(draws.numpy(), minlength=V) / n
    assert kept[draws.numpy()].all(), "draw outside the kept set"
    tv = 0.5 * np.abs(emp - p).sum()
    noise = 0.5 * np.sqrt(p * (1 - p) / n).sum()
    assert tv < 2.0 * noise + 1e-3, (tv, noise)


def test_unfiltered_draw_distribution_within_multinomial_noise():
    """With no filter the draw is a plain categorical over the softmax of
    all logits: 1e4 draws within the same multinomial-noise bound."""
    V, n = 256, 10_000
    row = np.random.default_rng(4).normal(0, 1, V).astype(np.float32)
    e = np.exp(row.astype(np.float64) - row.max())
    p = e / e.sum()
    draws = sample_top_k_top_p(torch.from_numpy(np.tile(row, (n, 1))), 0, 0.0,
                               torch.Generator().manual_seed(2))
    emp = np.bincount(draws.numpy(), minlength=V) / n
    tv = 0.5 * np.abs(emp - p).sum()
    noise = 0.5 * np.sqrt(p * (1 - p) / n).sum()
    assert tv < 2.0 * noise + 1e-3, (tv, noise)


def test_gumbel_noise_is_seeded():
    a = gumbel_noise((3, 5), torch.Generator().manual_seed(0))
    b = gumbel_noise((3, 5), torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.isfinite(a).all()


def kept_by_selection(l: torch.Tensor, top_k: int, top_p: float):
    """Kernel K2's route to the bisection's kept set, in fp32 torch: v_k (the
    k-th largest logit) by torch.topk, then the 26 midpoints replayed
    against it (count(l >= mid) >= k holds exactly when v_k >= mid); y* (the
    largest kept logit whose mass at or above it reaches top_p * Z) by a
    sort and a cumulative sum, then the midpoints replayed against it (the
    kept mass above mid reaches top_p * Z exactly when mid < y*). Returns
    (kept, margin): margin is, per row, the distance of the cumulative mass
    from top_p * Z on either side of the crossing, over Z (in fp64)."""
    V = l.shape[-1]
    m = l.max(dim=-1, keepdim=True).values
    lo0 = m - TAIL_NATS

    def replay(test):
        lo, hi = lo0, m + 1.0
        for _ in range(N_ITER):
            mid = 0.5 * (lo + hi)
            t = test(mid)
            lo, hi = torch.where(t, mid, lo), torch.where(t, hi, mid)
        return lo

    thr_k = lo0
    if 0 < top_k < V:
        vk = torch.topk(l, top_k, dim=-1).values[:, -1:]
        thr_k = replay(lambda mid: vk >= mid)
    kept = l >= thr_k
    margin = torch.full((l.shape[0],), float("inf"), dtype=torch.float64)
    if top_p > 0.0:
        e = torch.where(kept, torch.exp(l - m), 0.0)
        order = torch.argsort(l, dim=-1, descending=True, stable=True)
        cum = torch.cumsum(e.gather(1, order), dim=-1)
        pz = top_p * cum[:, -1:]
        first = torch.searchsorted(cum, pz).clamp_max(V - 1)  # first cum >= pz
        ys = l.gather(1, order.gather(1, first))
        kept = kept & (l > replay(lambda mid: mid < ys))
        c64, p64 = cum.double(), pz.double()
        above = c64.gather(1, first) - p64
        below = p64 - torch.where(first > 0, c64.gather(1, (first - 1).clamp_min(0)), 0.0)
        # at top_p >= 1 the crossing is the end of the sum on both sides
        near = below if top_p >= 1.0 else torch.minimum(above, below)
        margin = (near / c64[:, -1:]).squeeze(1)
    return kept, margin


def _selection_rows(kind, V, seed):
    rng = np.random.default_rng(seed)
    l = rng.normal(0, 3.0, (64, V)).astype(np.float32)
    l[:, :8] += 10.0  # a peaked head, as CFG logits have
    if kind == "ties":  # values on a coarse grid
        l = np.round(4.0 * l) / 4.0
    if kind == "tail":  # a third of each row more than 80 nats below the max
        l[:, ::3] -= 200.0
    return l


@pytest.mark.parametrize("kind,V,top_k,top_p", [
    ("random", 4096, 900, 0.96), ("random", 1000, 900, 0.96), ("ties", 4096, 900, 0.96),
    ("random", 4096, 1, 0.96), ("random", 4096, 4095, 0.96), ("ties", 1000, 999, 0.5),
    ("tail", 4096, 3000, 0.96), ("random", 4096, 50, 1.0), ("random", 1000, 0, 0.9)])
def test_selection_route_equals_jax_kept_mask(kind, V, top_k, top_p):
    """The top-k kept set of the selection route is bit-equal to the JAX
    package's kept_mask at top_p = 0 (the threshold is the bisection's bit
    for bit); with top-p the combined set equals it on every row whose
    crossing is more than 1e-5 of the mass from top_p * Z (fp32 sums in
    another order may move a nearer one), and those rows are at least 90%."""
    l = _selection_rows(kind, V, 7)
    tl = torch.from_numpy(l)
    want_k = np.asarray(kept_mask(jnp.asarray(l), top_k, 0.0, n_iter=26))
    np.testing.assert_array_equal(kept_by_selection(tl, top_k, 0.0)[0].numpy(), want_k)
    want = np.asarray(kept_mask(jnp.asarray(l), top_k, top_p, n_iter=26))
    got, margin = kept_by_selection(tl, top_k, top_p)
    clear = (margin > 1e-5).numpy()
    assert clear.mean() >= 0.9, clear.mean()
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])
