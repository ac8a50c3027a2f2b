"""K7 (flat-layout decode) and K8 (fused-cache decode) of the port against
the JAX package's Pallas kernels in interpret mode, and the decode blocks
that call them against the JAX package's.

The JAX flat cache is the port's: (B, H, hd, Lk) K^T and V^T. The JAX fused
cache pairs two heads a row, [k_2i | k_2i+1 | v_2i | v_2i+1]; the port keeps
one head a row, [k_h | v_h], and `_unpair` is the inverse of `_pair_heads`.
fp32 inputs from numpy: the plain versions agree with the kernels to fp32
reassociation (atol 1e-5), and K8's plain version equals K1's bit for bit on
the same rows, as the JAX package's fused kernel equals its paired one."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlvar_tpu.config import VARConfig as JVARCfg
from controlvar_tpu.models import transformer as jtfm
from controlvar_tpu.ops.attention import flash_decode, flash_decode_fused

from controlvar_tpu_torch.ckpt.convert import to_jax_params
from controlvar_tpu_torch.config import VARConfig
from controlvar_tpu_torch.models import transformer as tfm
from controlvar_tpu_torch.models.var import VARModel
from controlvar_tpu_torch.ops.attention import (decode_attention, decode_attention_flat,
                                                decode_attention_flat_plain,
                                                decode_attention_fused,
                                                decode_attention_fused_plain,
                                                decode_attention_plain)

from tests.torch_fixtures import one_torch_thread  # noqa: F401

SCALE = 0.125


def _normal(rng, *shape):
    return rng.normal(0, 1, shape).astype(np.float32)


def _unpair(t):
    """(..., H/2, L, 2 hd) -> (..., H, L, hd), the inverse of `_pair_heads`."""
    t = np.asarray(t)
    *lead, h2, L, hd2 = t.shape
    t = t.reshape(*lead, h2, L, 2, hd2 // 2)
    return np.moveaxis(t, -2, -3).reshape(*lead, 2 * h2, L, hd2 // 2)


def _mask(rng, l, cur):
    mask = rng.random((l, cur)) > 0.3
    mask[:, 0] = True
    return mask


@pytest.mark.parametrize("hd,H,l,cur,masked", [(16, 3, 5, 13, False), (32, 4, 11, 29, True),
                                              (64, 3, 9, 40, True), (128, 2, 3, 17, False),
                                              (32, 5, 1, 1, False)])
def test_flat_plain_matches_jax_kernel(hd, H, l, cur, masked):
    """K7's plain version vs `flash_decode` (interpret mode) at hd 16 to 128,
    odd and even H, l off the TPU's 8-row tiling, unmasked and masked; the
    CPU dispatch reads layer li of a (depth, B, H, hd, L_max) cache and
    launches nothing."""
    rng = np.random.default_rng(hd + H + l)
    B, depth, li, L_max = 2, 3, 1, 48
    q = _normal(rng, B, H, l, hd)
    ck, cv = _normal(rng, depth, B, H, hd, L_max), _normal(rng, depth, B, H, hd, L_max)
    mask = _mask(rng, l, cur) if masked else None
    want = flash_decode(jnp.asarray(q), jnp.asarray(ck[li, ..., :cur]),
                        jnp.asarray(cv[li, ..., :cur]),
                        mask=None if mask is None else jnp.asarray(mask), scale=SCALE,
                        interpret=True)
    t = torch.from_numpy
    m = None if mask is None else t(mask)
    got = decode_attention_flat_plain(t(q), t(ck[li, ..., :cur]), t(cv[li, ..., :cur]), SCALE, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    torch.testing.assert_close(decode_attention_flat(t(q), t(ck), t(cv), li, cur, SCALE, m), got,
                               rtol=0, atol=0)
    assert decode_attention_flat.launches == 0


@pytest.mark.parametrize("l,cur,masked", [(7, 23, False), (12, 30, True)])
def test_fused_plain_matches_jax_kernel_and_k1(l, cur, masked):
    """K8's plain version vs `flash_decode_fused` (interpret mode) on the
    same rows, heads unpaired; equal bit for bit to K1's plain version over
    the paired layout's two caches holding those rows."""
    rng = np.random.default_rng(l + cur)
    B, H, hd, depth, li, L_max = 2, 4, 64, 2, 1, 40
    q = _normal(rng, B, H, l, hd)
    ck, cv = _normal(rng, depth, B, H, L_max, hd), _normal(rng, depth, B, H, L_max, hd)
    kv = np.concatenate([ck, cv], axis=-1)                 # the port's fused rows
    mask = _mask(rng, l, cur) if masked else None
    j_kv = jnp.concatenate([jtfm._pair_heads(jnp.asarray(ck[li, :, :, :cur])),
                            jtfm._pair_heads(jnp.asarray(cv[li, :, :, :cur]))], axis=-1)
    want = flash_decode_fused(jnp.asarray(q), j_kv,
                              mask=None if mask is None else jnp.asarray(mask), scale=SCALE,
                              interpret=True)
    t = torch.from_numpy
    m = None if mask is None else t(mask)
    got = decode_attention_fused_plain(t(q), t(kv[li, :, :, :cur]), SCALE, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert torch.equal(got, decode_attention(t(q), t(ck), t(cv), li, cur, SCALE, m))
    assert torch.equal(decode_attention_fused(t(q), t(kv), li, cur, SCALE, m), got)
    assert torch.equal(got, decode_attention_plain(t(q), t(ck[li, :, :, :cur]),
                                                   t(cv[li, :, :, :cur]), SCALE, m))
    assert decode_attention_fused.launches == 0


def test_wrappers_reject_other_devices():
    q = torch.zeros(1, 3, 2, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention_flat(q, torch.zeros(1, 1, 3, 32, 8, device="meta"),
                              torch.zeros(1, 1, 3, 32, 8, device="meta"), 0, 2, SCALE)
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention_fused(torch.zeros(1, 2, 2, 64, device="meta"),
                               torch.zeros(1, 1, 2, 8, 128, device="meta"), 0, 2, SCALE)


# (config overrides, fused cache): three heads of 64 and four of 32 take the
# flat layout; two heads of 64 the paired one, here fused
BLOCK_CASES = {"flat-odd-heads": (dict(embed_dim=192, num_heads=3), False),
               "flat-hd32": (dict(embed_dim=128, num_heads=4), False),
               "fused": (dict(embed_dim=128, num_heads=2), True)}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_blocks_decode_layouts_match_jax(case, monkeypatch):
    """blocks_decode over the flat caches (K7's plain version, transposed
    writes) and over the fused cache (K8's) vs the JAX blocks_decode (its
    flat branch; its fused branch under CONTROLVAR_KV_FUSED=1) over three
    scale steps: every step's output and the final caches to 1e-4."""
    over, fused = BLOCK_CASES[case]
    kw = dict(depth=2, patch_nums=(1, 2, 4), vocab_size=64, cvae=32, num_classes=8, **over)
    jcfg, cfg = JVARCfg(**kw), VARConfig(**kw)
    assert tfm.kv_layout(cfg) == ("paired" if fused else "flat") == jtfm.kv_layout(jcfg)
    if fused:
        monkeypatch.setenv("CONTROLVAR_KV_FUSED", "1")
    # the port's init carried to the JAX side (the JAX init runs ~7 s eagerly)
    tp = VARModel(cfg, device="cpu").init_params(1)
    jp = jax.tree_util.tree_map(jnp.asarray, to_jax_params(tp, cfg))
    rng = np.random.default_rng(0)
    cond = _normal(rng, 4, cfg.embed_dim)
    jk, jv = jtfm.init_kv_cache(jcfg, 4, jcfg.seq_len, jnp.float32)
    tk, tv = tfm.init_kv_cache(cfg, 4, cfg.seq_len, torch.float32, fused=fused)
    assert (tv.numel() == 0) == fused and (jv.ndim == 1) == fused
    pos = 0
    for n in (1, 4, 16):
        x = _normal(rng, 4, n, cfg.embed_dim)
        jy, jk, jv = jtfm.blocks_decode(jp["blocks"], jnp.asarray(x), jnp.asarray(cond), jcfg,
                                        jk, jv, pos)
        ty, tk, tv = tfm.blocks_decode(tp["blocks"], torch.from_numpy(x), torch.from_numpy(cond),
                                       cfg, tk, tv, pos)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4, rtol=0)
        pos += n
    if fused:
        jk = np.asarray(jk)[:, :, :, :pos]
        half = jk.shape[-1] // 2
        want = np.concatenate([_unpair(jk[..., :half]), _unpair(jk[..., half:])], axis=-1)
        np.testing.assert_allclose(tk[:, :, :, :pos].numpy(), want, atol=1e-4, rtol=0)
        return
    assert tk.shape[-1] % 8 == 0 and tk.shape[-1] >= cfg.seq_len
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got[..., :pos].numpy(), np.asarray(want)[..., :pos],
                                   atol=1e-4, rtol=0)
