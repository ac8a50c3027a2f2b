"""The port's VQVAE against the JAX package, fp32 on the CPU, same weights.

Tokenizer ids must be bit-identical; decoded pixels agree to fp32 conv
reassociation noise (atol 1e-4 over a 64x64 decode through ~30 convs).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlvar_tpu.config import VQVAEConfig as JVQ
from controlvar_tpu.models.vqvae import VQVAE as JVQVAE
from controlvar_tpu.ops import resize as jresize

from controlvar_tpu_torch.ckpt.convert import from_jax_params
from controlvar_tpu_torch.config import VQVAEConfig
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.ops.resize import upsample_nearest_2x

from tests.torch_fixtures import one_torch_thread  # noqa: F401

CFG = dict(ch=32, patch_nums=(1, 2, 4), vocab_size=64)


@pytest.fixture(scope="module")
def vq():
    jv = JVQVAE(JVQ(**CFG))
    jp = jv.init_params(jax.random.key(0))
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), VQVAEConfig(**CFG),
                         device="cpu")
    return jv, jp, VQVAE(VQVAEConfig(**CFG), device="cpu"), tp


def test_img_to_ids_bitwise(vq):
    jv, jp, tv, tp = vq
    img = np.random.default_rng(0).uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    want = jax.jit(jv.img_to_ids)(jp, jnp.asarray(img))
    got = tv.img_to_ids(tp, torch.from_numpy(img))
    for si, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"scale {si}")


def test_fhat_to_img_allclose(vq):
    jv, jp, tv, tp = vq
    f_hat = np.random.default_rng(1).normal(0, 1, (2, 4, 4, 32)).astype(np.float32)
    want = jax.jit(jv.fhat_to_img)(jp, jnp.asarray(f_hat))
    got = tv.fhat_to_img(tp, torch.from_numpy(f_hat))
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_upsample_nearest_2x_matches_jax():
    x = np.random.default_rng(2).normal(0, 1, (2, 3, 5, 4)).astype(np.float32)
    want = np.asarray(jresize.upsample_nearest_2x(jnp.asarray(x)))   # NHWC
    got = upsample_nearest_2x(torch.from_numpy(x).permute(0, 3, 1, 2))  # NCHW
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_convert_transposes_conv_kernels(vq):
    _, jp, _, tp = vq
    w = np.asarray(jp["encoder"]["conv_in"]["kernel"])             # HWIO
    np.testing.assert_array_equal(tp["encoder"]["conv_in"]["kernel"].numpy(),
                                  w.transpose(3, 2, 0, 1))         # OIHW
