"""K5 (prefix decode) and K6 (in-place decode) of the port against the JAX
package's Pallas kernels in interpret mode, and the decode blocks that call
them against the JAX package's.

The port keeps one head per cache row, the JAX package two (`_pair_heads`);
`_unpair` is its inverse. fp32 inputs from numpy: the plain versions agree
with the kernels to fp32 reassociation (atol 2e-5), and K6's cache rows
[0, cur) are bit-equal."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlvar_tpu.config import ControlVARConfig as JCfg
from controlvar_tpu.models import transformer as jtfm
from controlvar_tpu.models.control_var import ControlVARModel as JModel
from controlvar_tpu.models.masks import attn_mask_for_config
from controlvar_tpu.ops.attention import flash_decode_inplace, flash_decode_prefix

from controlvar_tpu_torch.ckpt.convert import from_jax_params
from controlvar_tpu_torch.config import ControlVARConfig
from controlvar_tpu_torch.models import transformer as tfm
from controlvar_tpu_torch.ops.attention import (decode_attention_inplace,
                                                decode_attention_inplace_plain,
                                                decode_attention_prefix,
                                                decode_attention_prefix_plain,
                                                flash_attention_plain)

from tests.torch_fixtures import one_torch_thread  # noqa: F401

B, H, HD, SCALE = 2, 4, 64, 0.125
TINY = dict(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 4),
            vocab_size=64, cvae=32, num_classes=8, mask_factor=2, multi_cond=True)


def _unpair(t):
    """(..., H/2, L, 2 hd) -> (..., H, L, hd), the inverse of `_pair_heads`."""
    t = np.asarray(t)
    *lead, h2, L, hd2 = t.shape
    t = t.reshape(*lead, h2, L, 2, hd2 // 2)
    return np.moveaxis(t, -2, -3).reshape(*lead, 2 * h2, L, hd2 // 2)


def _pair(t):
    return jtfm._pair_heads(jnp.asarray(t))


def _normal(rng, *shape):
    return rng.normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("pos,l,masked", [(27, 13, False), (30, 5, True), (43, 21, True),
                                          (64, 13, True), (128, 72, False), (27, 70, True),
                                          (100, 130, True)])
def test_prefix_plain_matches_jax_kernel(pos, l, masked):
    """K5's plain version vs `flash_decode_prefix` (interpret mode) at pos
    and l off the TPU's 8-row tiling, at pos a multiple of the card
    kernel's 64-row tiles and at l above 64 and 128, unmasked and masked;
    the CPU dispatch of `decode_attention_prefix` is the plain version and
    launches nothing."""
    rng = np.random.default_rng(pos + l)
    L_max = max(64, pos + 8)  # a cache with room past pos, as the decode path has
    q, k_new, v_new = (_normal(rng, B, H, l, HD) for _ in range(3))
    cache_k, cache_v = _normal(rng, B, H, L_max, HD), _normal(rng, B, H, L_max, HD)
    mask = None
    if masked:
        mask = rng.random((l, pos + l)) > 0.3
        mask[:, 0] = True
    want = flash_decode_prefix(jnp.asarray(q), _pair(cache_k), _pair(cache_v), _pair(k_new),
                               _pair(v_new), pos, mask=None if mask is None else jnp.asarray(mask),
                               scale=SCALE, block_q=8, interpret=True)
    t = torch.from_numpy
    args = (t(q), t(cache_k[:, :, :pos]), t(cache_v[:, :, :pos]), t(k_new), t(v_new), SCALE,
            None if mask is None else t(mask))
    got = decode_attention_prefix_plain(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    torch.testing.assert_close(decode_attention_prefix(*args), got, rtol=0, atol=0)
    assert decode_attention_prefix.launches == 0


def test_prefix_at_pos_0_is_the_fresh_rows_alone():
    """pos = 0 (an empty prefix) is attention over the fresh rows: the
    public function takes it, though the segmented path sends scale 0 to
    K1."""
    rng = np.random.default_rng(9)
    q, k_new, v_new = (torch.from_numpy(_normal(rng, B, H, 21, HD)) for _ in range(3))
    empty = torch.zeros(B, H, 0, HD)
    mask = torch.from_numpy(rng.random((21, 21)) > 0.4)
    mask[:, 0] = True
    for m in (None, mask):
        got = decode_attention_prefix(q, empty, empty, k_new, v_new, SCALE, m)
        want = flash_attention_plain(q, k_new, v_new, m, SCALE)[0]
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("pos,l", [(19, 11), (0, 13), (32, 8)])
def test_inplace_plain_matches_jax_kernel(pos, l):
    """K6's plain version vs `flash_decode_inplace` (interpret mode): the
    outputs to 2e-5 and the caches' rows [0, cur) bit-equal; the port
    writes exactly rows [pos, cur) of layer li (the JAX kernel also writes
    zero rows up to its 8-row padding past cur)."""
    rng = np.random.default_rng(pos + 3 * l)
    depth, li, L_max = 3, 1, 56
    q, k_new, v_new = (_normal(rng, B, H, l, HD) for _ in range(3))
    ck, cv = _normal(rng, depth, B, H, L_max, HD), _normal(rng, depth, B, H, L_max, HD)
    pk = jnp.stack([_pair(c) for c in ck])
    pv = jnp.stack([_pair(c) for c in cv])
    want, jk, jv = flash_decode_inplace(jnp.asarray(q), pk, pv, _pair(k_new), _pair(v_new),
                                        jnp.int32(li), pos, scale=SCALE, block_q=8,
                                        interpret=True)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = decode_attention_inplace(torch.from_numpy(q), tk, tv, torch.from_numpy(k_new),
                                   torch.from_numpy(v_new), li, pos, SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    cur = pos + l
    for got_c, want_c, before, new in ((tk, jk, ck, k_new), (tv, jv, cv, v_new)):
        np.testing.assert_array_equal(got_c.numpy()[:, :, :, :cur],
                                      np.stack([_unpair(c) for c in want_c])[:, :, :, :cur])
        changed = before.copy()
        changed[li, :, :, pos:cur] = new
        np.testing.assert_array_equal(got_c.numpy(), changed)  # no other row moved
    assert decode_attention_inplace.launches == 0


def test_inplace_plain_is_write_then_prefix_plain():
    rng = np.random.default_rng(5)
    q, k_new, v_new = (torch.from_numpy(_normal(rng, B, H, 7, HD)) for _ in range(3))
    ck = torch.from_numpy(_normal(rng, 2, B, H, 40, HD))
    cv = torch.from_numpy(_normal(rng, 2, B, H, 40, HD))
    want = decode_attention_prefix_plain(q, ck[0, :, :, :20], cv[0, :, :, :20], k_new, v_new,
                                         SCALE)
    got = decode_attention_inplace_plain(q, ck, cv, k_new, v_new, 0, 20, SCALE)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(ck[0, :, :, 20:27], k_new, rtol=0, atol=0)


@pytest.fixture(scope="module")
def weights():
    jp = jax.jit(JModel(JCfg(**TINY)).init_params)(jax.random.key(1))
    return jp, from_jax_params(jax.tree_util.tree_map(np.asarray, jp), ControlVARConfig(**TINY),
                               device="cpu")


def _steps(rng):
    cond = _normal(rng, 4, 128)
    return cond, [_normal(rng, 4, n, 128) for n in (2, 8, 32)]


def test_inplace_blocks_decode_matches_jax(weights, monkeypatch):
    """blocks_decode(inplace=True) (K6's plain version in every layer) vs
    the JAX blocks_decode under CONTROLVAR_INPLACE_DECODE=1 (its Pallas
    kernel in interpret mode), over the three scale steps of the tiny
    config: every step's output and the final caches to 1e-4."""
    jcfg, cfg = JCfg(**TINY), ControlVARConfig(**TINY)
    jp, tp = weights
    cond, xs = _steps(np.random.default_rng(0))
    monkeypatch.setenv("CONTROLVAR_INPLACE_DECODE", "1")
    jk, jv = jtfm.init_kv_cache(jcfg, 4, jcfg.seq_len, jnp.float32)
    tk, tv = tfm.init_kv_cache(cfg, 4, cfg.seq_len, torch.float32)
    pos = 0
    for x in xs:
        jy, jk, jv = jtfm.blocks_decode(jp["blocks"], jnp.asarray(x), jnp.asarray(cond), jcfg,
                                        jk, jv, pos)
        ty, tk, tv = tfm.blocks_decode(tp["blocks"], torch.from_numpy(x), torch.from_numpy(cond),
                                       cfg, tk, tv, pos, inplace=True)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4, rtol=0)
        pos += x.shape[1]
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), _unpair(want)[:, :, :, :pos], atol=1e-4, rtol=0)


@pytest.mark.parametrize("indep", [False, True])
def test_seg_blocks_decode_matches_jax(weights, indep):
    """blocks_decode_seg (K1's plain version at scale 0, K5's after it) vs
    the JAX blocks_decode_seg over the three scale steps, unmasked and under
    the `indep` mask; the segments are this scale's K/V."""
    variant = dict(separate_decoding=True, indep=True) if indep else {}
    jcfg, cfg = JCfg(**TINY, **variant), ControlVARConfig(**TINY, **variant)
    jp, tp = weights
    cond, xs = _steps(np.random.default_rng(1))
    full = attn_mask_for_config(jcfg)
    jsk, jsv, tsk, tsv = (), (), (), ()
    pos = 0
    for x in xs:
        cur = pos + x.shape[1]
        m = full[pos:cur, :cur] if indep else None
        jy, jk, jv = jtfm.blocks_decode_seg(jp["blocks"], jnp.asarray(x), jnp.asarray(cond),
                                            jcfg, jsk, jsv,
                                            mask_slice=None if m is None else jnp.asarray(m))
        ty, tk, tv = tfm.blocks_decode_seg(tp["blocks"], torch.from_numpy(x),
                                           torch.from_numpy(cond), cfg, tsk, tsv,
                                           mask_slice=None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4, rtol=0)
        np.testing.assert_allclose(tk.numpy(), _unpair(jk), atol=1e-4, rtol=0)
        jsk, jsv, tsk, tsv = jsk + (jk,), jsv + (jv,), tsk + (tk,), tsv + (tv,)
        pos = cur
    if indep:
        assert not full[10:42, :42].all()  # the last step's mask masks something
