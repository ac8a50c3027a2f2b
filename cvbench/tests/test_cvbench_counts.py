"""`cvbench/counts.py` against counts made by hand at small shapes."""
import pytest

from cvbench import counts

M = dict(depth=1, embed_dim=4, num_heads=2, mlp_ratio=4.0, vocab_size=8, cvae=2,
         patch_nums=[1, 2])
V = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, z_channels=4, quant_conv_ks=3)


def test_scales_and_pairs():
    assert counts.scales(M) == [(2, 0, 2), (8, 2, 10)]
    assert counts.unmasked_pairs(M) == 2 * 2 + 8 * 10


def test_transformer_forward_flops():
    per_token = 2 * (3 * 16 + 16 + 2 * 4 * 16) + 2 * 2 * 4        # qkv, proj, fc1, fc2; embed
    per_row = 10 * per_token + 4 * 4 * 84 + 2 * 4 * 24 + 2 * 4 * 8  # attention; AdaLN; head AdaLN
    head = 10 * 2 * 4 * 8
    assert counts.transformer_forward_flops(M, 3, 1) == 3 * per_row + head


def test_k1_bound():
    # rows 3, H 2, hd 2: scale 0 q 2 rows over 2, scale 1 q 8 rows over 10
    b0 = max(2 * (2 * 3 * 2 * 2 * 2 + 2 * 3 * 2 * 2 * 2) / 3.35e12,
             4 * 3 * 2 * 2 * 2 * 2 / 989e12)
    b1 = max(2 * (2 * 3 * 2 * 8 * 2 + 2 * 3 * 2 * 10 * 2) / 3.35e12,
             4 * 3 * 2 * 8 * 10 * 2 / 989e12)
    assert counts.k1_bound_s(M, 3) == pytest.approx(b0 + b1, rel=1e-12)


def test_k2_bound():
    n0, n1 = 5 * 3 * 1, 5 * 3 * 4          # batch 5, 3 pn^2 rows a sample
    want = sum(max((4 * n * 8 + 8 * n) / 3.35e12, 5 * n * 8 / 67e12) for n in (n0, n1))
    assert counts.k2_bound_s(M, 5) == pytest.approx(want, rel=1e-12)


def test_k3_k4_bounds():
    n, rows, L, per_score = 3 * 2 * 10 * 2, 3 * 2 * 10, 10, 3 * 2 * 2 * 84
    assert counts.k3_bound_s(M, 3) == max((8 * n + 4 * rows + L * L) / 3.35e12,
                                          4 * per_score / 989e12)
    assert counts.k4_bound_s(M, 3) == max((16 * n + 4 * rows + L * L) / 3.35e12,
                                          10 * per_score / 989e12)


def test_vqvae_encoder_flops():
    conv = lambda cin, cout, k, hw: 2 * cin * cout * k * k * hw * hw
    attn = conv(64, 192, 1, 4) + conv(64, 64, 1, 4) + 4 * 16 * 16 * 64
    want = (conv(3, 32, 3, 8)
            + conv(32, 32, 3, 8) * 2 + conv(32, 32, 3, 4)                      # level 0, down
            + conv(32, 64, 3, 4) + conv(64, 64, 3, 4) + conv(32, 64, 1, 4) + attn  # level 1
            + 4 * conv(64, 64, 3, 4) + attn                                     # mid
            + conv(64, 4, 3, 4) + conv(4, 4, 3, 4))                             # out, quant
    assert counts.vqvae_encode_flops(V, 8) == want == 10576384


def test_vqvae_decoder_flops():
    conv = lambda cin, cout, k, hw: 2 * cin * cout * k * k * hw * hw
    attn = conv(64, 192, 1, 4) + conv(64, 64, 1, 4) + 4 * 16 * 16 * 64
    want = (conv(4, 4, 3, 4) + conv(4, 64, 3, 4)                                # post quant, in
            + 4 * conv(64, 64, 3, 4) + attn                                     # mid
            + 2 * (2 * conv(64, 64, 3, 4) + attn)                               # level 1
            + conv(64, 64, 3, 8)                                                # upsample
            + conv(64, 32, 3, 8) + conv(32, 32, 3, 8) + conv(64, 32, 1, 8)      # level 0
            + 2 * conv(32, 32, 3, 8)
            + conv(32, 3, 3, 8))
    assert counts.vqvae_decode_flops(V, 8) == want


def test_step_and_call():
    v = dict(V, image_size=8)
    f = counts.transformer_forward_flops(M, 3, 3)
    assert counts.train_step_flops(M, v, 3) == 3 * f + 6 * counts.vqvae_encode_flops(V, 8)
    call = counts.cond_call_flops(M, v, 3)
    assert call == (counts.transformer_forward_flops(M, 12, 3)
                    + 3 * (counts.vqvae_encode_flops(V, 8) + counts.vqvae_decode_flops(V, 8)))
