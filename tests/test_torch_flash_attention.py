"""The port's training attention (kernels K3 and K4: their plain versions,
their CPU dispatch and the autograd Function over them) against the JAX
package's Pallas flash-attention forward and backward, run in interpret
mode, on the same fp32 inputs. L = 42 (the tiny ControlVAR pyramid) is not a
multiple of the 16-row blocks, so the JAX side pads and the port does not.
Agreement to fp32 reassociation noise: atol 2e-5 on outputs of order 1."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from controlvar_tpu.config import ControlVARConfig as JCfg
from controlvar_tpu.models.masks import attn_mask_for_config as j_mask_for_config
from controlvar_tpu.ops.attention import flash_attention as j_flash_attention
from controlvar_tpu.ops.attention import flash_attention_bwd as j_flash_attention_bwd
from controlvar_tpu.ops.attention import mha_xla as j_mha_xla

from controlvar_tpu_torch.ops.attention import (
    NEG_INF, flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_plain, flash_mha, tile_flags)

B, H, HD = 2, 2, 64
SCALE = 0.125


def mha_einsum(q, k, v, scale, mask):
    """Plain einsum attention, differentiable by autograd: the JAX package's
    `mha_xla` (scores in q's dtype, fp32 mask and softmax, probabilities in
    v's dtype), the reference the flash path is held to."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q * torch.tensor(scale, dtype=q.dtype), k)
    probs = torch.softmax(torch.where(mask, logits.float(), NEG_INF), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def _tile_pattern(L, tile, seed):
    """A random pattern of tile x tile blocks (about half fully masked, a
    quarter mixed, a quarter full) with the diagonal kept, so every row
    attends somewhere: its fully masked blocks are not one contiguous run."""
    rng = np.random.default_rng(seed)
    nt = -(-L // tile)
    kind = np.kron(rng.integers(0, 4, (nt, nt)), np.ones((tile, tile), int))[:L, :L]
    mask = (kind == 3) | ((kind == 2) & (rng.random((L, L)) > 0.5))
    np.fill_diagonal(mask, True)
    return mask


def _mask(kind):
    if kind == "block_causal":
        cfg = JCfg(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 4),
                   vocab_size=64, num_classes=8, multi_cond=True)
        return np.asarray(j_mask_for_config(cfg))
    if kind == "tile_pattern":  # at the 16-row blocks of the Pallas kernels below
        return _tile_pattern(42, 16, 0)
    return np.tril(np.ones((42, 42), bool))


def _inputs(seed, L=42, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (B, H, L, HD)).astype(dtype) for _ in range(4)]


@pytest.mark.parametrize("kind", ["block_causal", "tril", "tile_pattern"])
def test_plain_forward_and_backward_match_pallas_interpret(kind):
    mask = _mask(kind)
    assert mask.shape == (42, 42) and not mask.all()
    q, k, v, g = _inputs(0)
    jq, jk, jv, jg, jm = (jnp.asarray(t) for t in (q, k, v, g, mask))
    j_out, j_lse = j_flash_attention(jq, jk, jv, jm, SCALE, block_q=16, block_k=16,
                                     interpret=True, return_lse=True)
    j_dq, j_dk, j_dv = j_flash_attention_bwd(jq, jk, jv, jm, j_out, j_lse, jg, SCALE,
                                             block_q=16, block_k=16, interpret=True)
    tq, tk, tv, tg, tm = (torch.from_numpy(t) for t in (q, k, v, g, mask))
    out, lse = flash_attention_plain(tq, tk, tv, tm, SCALE)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=2e-5, rtol=0)
    grads = flash_attention_bwd_plain(tq, tk, tv, tm, out, lse, tg, SCALE)
    for name, got, want in zip(("dq", "dk", "dv"), grads, (j_dq, j_dk, j_dv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0,
                                   err_msg=name)


def test_plain_forward_matches_einsum_attention():
    """The forward's out equals the einsum attention (fp32: no rounding
    points apart), which equals the JAX package's mha_xla, and its lse is
    logsumexp of the masked scores."""
    mask = torch.from_numpy(_mask("block_causal"))
    qn, kn, vn = _inputs(1)[:3]
    q, k, v = (torch.from_numpy(t) for t in (qn, kn, vn))
    out, lse = flash_attention_plain(q, k, v, mask, SCALE)
    einsum = mha_einsum(q, k, v, SCALE, mask)
    torch.testing.assert_close(out, einsum, atol=1e-5, rtol=0)
    want = j_mha_xla(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), SCALE,
                     jnp.asarray(_mask("block_causal")))
    np.testing.assert_allclose(einsum.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    s = torch.where(mask, (q * SCALE) @ k.transpose(-1, -2), -1e30)
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), atol=1e-5, rtol=0)


def test_cpu_dispatch_takes_the_plain_versions():
    mask = torch.from_numpy(_mask("tril"))
    q, k, v, g = (torch.from_numpy(t) for t in _inputs(2))
    out, lse = flash_attention(q, k, v, mask, SCALE)
    want_out, want_lse = flash_attention_plain(q, k, v, mask, SCALE)
    torch.testing.assert_close(out, want_out, atol=0, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=0, rtol=0)
    got = flash_attention_bwd(q, k, v, mask, out, lse, g, SCALE)
    want = flash_attention_bwd_plain(q, k, v, mask, out, lse, g, SCALE)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert flash_attention.launches == 0 and flash_attention_bwd.launches == 0


def test_flash_mha_gradcheck_float64():
    """The autograd Function's backward (the plain K4) is the derivative of
    its forward (the plain K3), checked by finite differences in fp64 on
    permuted (non-contiguous) q, k, v as the transformer passes them."""
    rng = np.random.default_rng(3)
    L, hd = 9, 8
    mask = torch.from_numpy(np.tril(np.ones((L, L), bool)) | (np.arange(L) < 3)[None, :])
    qkv = torch.from_numpy(rng.normal(0, 1, (1, L, 3, 2, hd))).requires_grad_(True)

    def attn(x):
        q, k, v = x.permute(2, 0, 3, 1, 4)
        return flash_mha(q, k, v, mask, 0.4)

    assert torch.autograd.gradcheck(attn, (qkv,))


def test_flash_mha_backward_matches_autograd_of_einsum():
    """fp32: flash_mha's gradients equal autograd through the einsum
    attention."""
    mask = torch.from_numpy(_mask("block_causal"))
    q, k, v, g = (torch.from_numpy(t) for t in _inputs(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_mha(*leaves, mask, SCALE).backward(g)
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    mha_einsum(*ref, SCALE, mask).backward(g)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, atol=2e-5, rtol=0)


def test_wrappers_reject_other_devices():
    q = torch.zeros(1, 2, 8, 64, device="meta")
    mask = torch.ones(8, 8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q, mask, SCALE)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_bwd(q, q, q, mask, q, torch.zeros(1, 2, 8, device="meta"), q, SCALE)


@pytest.mark.parametrize("kind", ["block_causal", "tril", "d16", "indep", "tile_pattern",
                                  "rows_without_true"])
def test_tile_flags_match_each_tile(kind):
    """The kernels' per-tile mask flags (1: no False; 2: no True, where
    every row of the tile's 64 query rows has a True somewhere, so that K4
    may skip the tile; else 0) over the part of each 64 x 64 tile inside L,
    against a loop over tiles and rows; L = 42, 300 and 1360 are not
    multiples of 64. The training masks and the tile pattern attend from
    every row; the last mask has rows that attend nowhere, whose tiles are
    never flagged 2."""
    from controlvar_tpu_torch.models.masks import block_causal_mask, separate_decoding_mask

    pn = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)
    if kind == "d16":
        mask = block_causal_mask(pn, 2)
    elif kind == "indep":
        mask = separate_decoding_mask(pn, indep=True)
    elif kind == "tile_pattern":
        mask = _tile_pattern(300, 64, 1)
    elif kind == "rows_without_true":
        mask = np.tril(np.ones((300, 300), bool))
        mask[[70, 200, 201]] = False
    else:
        mask = _mask(kind)
    L = mask.shape[0]
    flags = tile_flags(torch.from_numpy(mask)).numpy()
    nt = -(-L // 64)
    assert flags.shape == (nt, nt) and flags.dtype == np.uint8
    for i in range(nt):
        rows_attend = all(mask[r].any() for r in range(64 * i, min(L, 64 * i + 64)))
        for j in range(nt):
            tile = mask[64 * i:64 * i + 64, 64 * j:64 * j + 64]
            want = 1 if tile.all() else 2 if not tile.any() and rows_attend else 0
            assert flags[i, j] == want, (i, j)
    counts = {int(v): int((flags == v).sum()) for v in (0, 1, 2)}
    if kind == "d16":
        assert counts == {0: 35, 1: 286, 2: 163}
    if kind == "tile_pattern":  # fully masked tiles before unmasked ones in a row
        assert any(flags[i, j] == 2 and (flags[i, j + 1:] != 2).any()
                   for i in range(nt) for j in range(nt))
    if kind == "rows_without_true":  # tile rows 1 and 3 hold rows 70, 200, 201
        assert counts[2] > 0 and not (flags[[1, 3]] == 2).any()


def test_kernel_flags_are_checked_or_computed():
    """The wrappers take the caller's tile flags after checking their shape,
    dtype and layout, and compute them when none are given."""
    from controlvar_tpu_torch.ops.attention import _kernel_flags

    mask = torch.from_numpy(np.tril(np.ones((100, 100), bool)))
    assert _kernel_flags(mask, None).tolist() == [[0, 2], [1, 0]]
    flags = tile_flags(mask)
    assert _kernel_flags(mask, flags) is flags
    for bad in (flags[:1], flags.int(), flags.t()):
        with pytest.raises(ValueError, match="flags must be"):
            _kernel_flags(mask, bad)
