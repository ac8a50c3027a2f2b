"""The port's bisection sampler (kernel K2's plain version and its CPU
dispatch) against the JAX package's `kept_mask` and interpret-mode kernel."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlvar_tpu.ops.sample_kernel import kept_mask, sample_top_k_top_p_bisect as j_bisect

from controlvar_tpu_torch.ops.sample_kernel import (
    gumbel_noise, kept_mask_plain, sample_bisect_plain, sample_top_k_top_p_bisect)
from controlvar_tpu_torch.ops.sampling import sample_top_k_top_p


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
