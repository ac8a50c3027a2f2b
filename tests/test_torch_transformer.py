"""The port's decode blocks and CFG head against the JAX package, fp32 on
the CPU, same weights: two consecutive KV-cached decode steps (the second
reads the first one's cache rows), unmasked and with an `indep` mask slice,
and the CFG-combined head. Agreement to fp32 reassociation (atol 1e-4)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlvar_tpu.config import ControlVARConfig as JCfg
from controlvar_tpu.models import transformer as jtfm
from controlvar_tpu.models.control_var import ControlVARModel as JModel
from controlvar_tpu.models.masks import attn_mask_for_config as j_mask_for_config

from controlvar_tpu_torch.ckpt.convert import from_jax_params
from controlvar_tpu_torch.config import ControlVARConfig
from controlvar_tpu_torch.models import transformer as tfm
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.masks import attn_mask_for_config

from tests.torch_fixtures import one_torch_thread  # noqa: F401

TINY = dict(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 4),
            vocab_size=64, cvae=32, num_classes=8, mask_factor=2, multi_cond=True)
VARIANTS = {"plain": {}, "indep": dict(separate_decoding=True, indep=True),
            "cos_attn": dict(cos_attn=True)}


@pytest.fixture(scope="module")
def weights():
    jp = jax.jit(JModel(JCfg(**TINY)).init_params)(jax.random.key(1))
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def _cfgs(variant):
    return JCfg(**TINY, **VARIANTS[variant]), ControlVARConfig(**TINY, **VARIANTS[variant])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_two_decode_steps_match_jax(weights, variant):
    jcfg, cfg = _cfgs(variant)
    jp, tree = weights
    if cfg.cos_attn:  # the JAX init adds scale_mul only for cos_attn configs
        tree = dict(tree, blocks=dict(tree["blocks"],
                                      scale_mul=np.full((2, 2), 1.1, np.float32)))
        jp = dict(jp, blocks=dict(jp["blocks"], scale_mul=jnp.asarray(tree["blocks"]["scale_mul"])))
    tp = from_jax_params(tree, cfg, device="cpu")
    rng = np.random.default_rng(0)
    B = 4
    cond = rng.normal(0, 1, (B, 128)).astype(np.float32)
    xs = [rng.normal(0, 1, (B, n, 128)).astype(np.float32) for n in (2, 8)]
    full = attn_mask_for_config(cfg)
    np.testing.assert_array_equal(full, j_mask_for_config(jcfg))

    jk, jv = jtfm.init_kv_cache(jcfg, B, jcfg.seq_len, jnp.float32)
    tk, tv = tfm.init_kv_cache(cfg, B, cfg.seq_len, torch.float32)
    pos = 0
    for x in xs:
        cur = pos + x.shape[1]
        m = full[pos:cur, :cur] if cfg.indep else None
        jy, jk, jv = jtfm.blocks_decode(jp["blocks"], jnp.asarray(x), jnp.asarray(cond),
                                        jcfg, jk, jv, pos,
                                        mask_slice=None if m is None else jnp.asarray(m))
        ty, tk, tv = tfm.blocks_decode(tp["blocks"], torch.from_numpy(x),
                                       torch.from_numpy(cond), cfg, tk, tv, pos,
                                       mask_slice=None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4, rtol=0)
        pos = cur
    if cfg.indep:
        assert not full[2:10, :10].all()  # the second step's mask masks something


@pytest.mark.parametrize("weights_cfg", [(3.0, -1.0, -1.0), (1.5, 0.5, -1.0, 0.0)])
def test_head_logits_cfg_matches_jax(weights, weights_cfg):
    jcfg, cfg = _cfgs("plain")
    jp, tree = weights
    tp = from_jax_params(tree, cfg, device="cpu")
    R, B = len(weights_cfg), 2
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (R * B, 8, 128)).astype(np.float32)
    cond = rng.normal(0, 1, (R * B, 128)).astype(np.float32)
    want = jtfm.head_logits_cfg(jp, jnp.asarray(x), jnp.asarray(cond), jcfg, weights_cfg)
    got = tfm.head_logits_cfg(tp, torch.from_numpy(x), torch.from_numpy(cond), cfg,
                              weights_cfg)
    assert got.shape == (B, 8, cfg.head_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_lvl_pos_and_word_embed_match_jax(weights):
    jcfg, cfg = _cfgs("plain")
    jp, tree = weights
    tp = from_jax_params(tree, cfg, device="cpu")
    jm, tm = JModel(jcfg), ControlVARModel(cfg, device="cpu")
    np.testing.assert_allclose(tm._lvl_pos(tp).numpy(), np.asarray(jm._lvl_pos(jp)),
                               atol=1e-6, rtol=0)
    x = np.random.default_rng(2).normal(0, 1, (2, 4, 32)).astype(np.float32)
    np.testing.assert_allclose(tm._word_embed(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jm._word_embed(jp, jnp.asarray(x))),
                               atol=1e-5, rtol=0)
