"""The port's decode attention (kernel K1's plain version and its CPU
dispatch) against the JAX package's paired-head decode kernel, run in Pallas
interpret mode, and against its einsum path. fp32 inputs; agreement to fp32
reassociation noise (atol 1e-5)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from controlvar_tpu.models.transformer import _mha_decode_paired, _pair_heads
from controlvar_tpu.ops.attention import flash_decode_paired

from controlvar_tpu_torch.ops.attention import decode_attention, decode_attention_plain

from tests.torch_fixtures import one_torch_thread  # noqa: F401

B, H, HD, LK = 2, 4, 64, 48


def _inputs(l, with_mask, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, H, l, HD)).astype(np.float32)
    k = rng.normal(0, 1, (B, H, LK, HD)).astype(np.float32)
    v = rng.normal(0, 1, (B, H, LK, HD)).astype(np.float32)
    mask = None
    if with_mask:
        mask = rng.random((l, LK)) > 0.3
        mask[:, 0] = True
    return q, k, v, mask


@pytest.mark.parametrize("l,with_mask", [(12, False), (16, True), (5, False), (7, True)])
def test_plain_matches_jax_kernel_and_einsum(l, with_mask):
    q, k, v, mask = _inputs(l, with_mask, l)
    kp, vp = _pair_heads(jnp.asarray(k)), _pair_heads(jnp.asarray(v))
    jmask = None if mask is None else jnp.asarray(mask)
    want_kernel = flash_decode_paired(jnp.asarray(q), kp, vp, mask=jmask, scale=0.125,
                                      block_q=8, bh_block=2, interpret=True)
    want_einsum = _mha_decode_paired(jnp.asarray(q), kp, vp, 0.125, jmask,
                                     use_pallas=False)
    got = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), 0.125,
                                 None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_einsum), atol=1e-5, rtol=0)


@pytest.mark.parametrize("with_mask", [False, True])
def test_cpu_dispatch_reads_layer_prefix_of_stacked_cache(with_mask):
    """decode_attention on CPU tensors = the plain version over rows
    [0, cur) of layer li; rows past cur (here garbage) are never read."""
    l, cur, li = 6, 30, 1
    q, k, v, mask = _inputs(l, with_mask, 3)
    mask = None if mask is None else torch.from_numpy(mask[:, :cur])
    cache_k = torch.full((3, B, H, LK, HD), float("nan"))
    cache_v = torch.full((3, B, H, LK, HD), float("nan"))
    cache_k[li, :, :, :cur] = torch.from_numpy(k[:, :, :cur])
    cache_v[li, :, :, :cur] = torch.from_numpy(v[:, :, :cur])
    got = decode_attention(torch.from_numpy(q), cache_k, cache_v, li, cur, 0.125, mask)
    want = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k[:, :, :cur]),
                                  torch.from_numpy(v[:, :, :cur]), 0.125, mask)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert decode_attention.launches == 0  # the plain path launches nothing


@pytest.mark.parametrize("view,ok", [("fused_qkv", True), ("contiguous", True),
                                     ("head_dim_strided", False), ("misaligned_rows", False)])
def test_kernel_q_check_takes_fused_qkv_views(view, ok):
    """K1 and K8 read q through its (batch, head, row) strides on the card;
    their wrappers hold q to dense, 16-byte-aligned rows (the fused QKV's
    view passes) and raise on anything else instead of copying it."""
    from controlvar_tpu_torch.ops.attention import _check_operand

    base = torch.zeros(B, 6, 3, H, HD + 8, dtype=torch.bfloat16)
    q = {"fused_qkv": base[..., :HD].permute(2, 0, 3, 1, 4)[0],
         "contiguous": torch.zeros(B, H, 6, HD, dtype=torch.bfloat16),
         "head_dim_strided": torch.zeros(B, H, HD, 6, dtype=torch.bfloat16).transpose(2, 3),
         "misaligned_rows": base.flatten()[1:1 + B * H * 6 * HD].view(B, H, 6, HD)}[view]
    assert q.shape == (B, H, 6, HD)
    if ok:
        _check_operand("q", q, tuple(q.shape), q.device, "decode_attention")
    else:
        with pytest.raises(ValueError, match="dense and 16-byte"):
            _check_operand("q", q, tuple(q.shape), q.device, "decode_attention")
