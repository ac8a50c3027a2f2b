"""The port's quantizer and resizes against the JAX package, fp32 on the CPU.

Token ids must be bit-identical (the codebook argmin sees the same fp32
distances up to reassociation, far below the gaps between codes); the
residual canvas update agrees to fp32 rounding (atol 1e-5); the resize
matrices, built by the same numpy arithmetic, are equal.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlvar_tpu.config import VQVAEConfig as JVQ
from controlvar_tpu.models.quantizer import MultiScaleQuantizer as JQuant
from controlvar_tpu.models.quantizer import phi_index_table as j_phi_table
from controlvar_tpu.ops import resize as jresize

from controlvar_tpu_torch.ckpt.convert import from_jax_params
from controlvar_tpu_torch.config import VQVAEConfig
from controlvar_tpu_torch.models.quantizer import MultiScaleQuantizer, phi_index_table
from controlvar_tpu_torch.ops import resize

from tests.torch_fixtures import one_torch_thread  # noqa: F401

PNS = (1, 2, 3, 4, 6, 8)
CFG = dict(vocab_size=64, patch_nums=PNS)


@pytest.fixture(scope="module")
def quant():
    jq = JQuant(JVQ(**CFG))
    jp = jax.tree_util.tree_map(np.asarray, jq.init_params(jax.random.key(0)))
    tp = from_jax_params({"encoder": {}, "decoder": {}, "quantize": jp,
                          "quant_conv": {}, "post_quant_conv": {}},
                         VQVAEConfig(**CFG), device="cpu")["quantize"]
    return jq, jp, MultiScaleQuantizer(VQVAEConfig(**CFG)), tp


@pytest.mark.parametrize("n_in,n_out", [(16, 1), (16, 3), (16, 13), (13, 16),
                                        (2, 16), (256, 64)])
@pytest.mark.parametrize("mode", ["area", "bicubic"])
def test_resize_matrices_equal(mode, n_in, n_out):
    want = np.asarray(jresize.resize_matrix(n_in, n_out, mode))
    got = resize.resize_matrix(n_in, n_out, mode).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_scales,num_phi", [(10, 4), (6, 4), (10, 3), (3, 0)])
def test_phi_index_table_equal(num_scales, num_phi):
    assert phi_index_table(num_scales, num_phi) == j_phi_table(num_scales, num_phi)


def test_encode_ids_bitwise(quant):
    jq, jp, tq, tp = quant
    f = np.random.default_rng(0).normal(0, 1, (3, 8, 8, 32)).astype(np.float32)
    want = jq.encode_ids(jp, jnp.asarray(f))
    got = tq.encode_ids(tp, torch.from_numpy(f))
    assert len(got) == len(PNS)
    for si, (a, b) in enumerate(zip(want, got)):
        assert b.shape == (3, PNS[si] ** 2)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"scale {si}")


@pytest.mark.parametrize("si", range(len(PNS)))
def test_next_ar_input_allclose(quant, si):
    jq, jp, tq, tp = quant
    rng = np.random.default_rng(si)
    pn = PNS[si]
    f_hat = rng.normal(0, 1, (2, 8, 8, 32)).astype(np.float32)
    h = rng.normal(0, 1, (2, pn, pn, 32)).astype(np.float32)
    wf, wn = jq.next_ar_input(jp, si, jnp.asarray(f_hat), jnp.asarray(h))
    gf, gn = tq.next_ar_input(tp, si, torch.from_numpy(f_hat), torch.from_numpy(h))
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), atol=1e-5, rtol=0)


def test_embed_and_nearest_code(quant):
    jq, jp, tq, tp = quant
    ids = np.random.default_rng(1).integers(0, 64, (4, 5))
    np.testing.assert_array_equal(
        tq.embed(tp, torch.from_numpy(ids)).numpy(), np.asarray(jq.embed(jp, jnp.asarray(ids))))
    z = np.random.default_rng(2).normal(0, 1, (50, 32)).astype(np.float32)
    np.testing.assert_array_equal(tq.nearest_code(tp, torch.from_numpy(z)).numpy(),
                                  np.asarray(jq.nearest_code(jp, jnp.asarray(z))))
