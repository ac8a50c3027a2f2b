"""The port's evaluation harness (controlvar_tpu_torch/eval/harness.py)
against the JAX package's: `class_shard` over a grid of (classes, shards),
and `generate_fid_set` of both packages on the same weights (numpy trees
in the JAX layout, loaded by the port with `from_jax_params`; AdaLN gates
raised so that attention moves the canvases) with greedy sampling (top_k=1) and fp32 compute: the
same file tree, decoded pixels within 1 uint8 level and equal on >= 99.9%
of them, without and with a Gibbs step. Then the port alone: a two-shard
run bit-equal to a one-shard run (each batch draws from a generator of its
own), the truncation of `_to_uint8`, and the `sampler` route.

The JAX harness's compute dtype is its class attribute
(`controlvar_tpu/eval/harness.py:53`): the test patches it to fp32."""
import os

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp
import torch

from controlvar_tpu.config import ControlVARConfig as JCfg
from controlvar_tpu.config import SampleConfig as JSampleConfig
from controlvar_tpu.config import VQVAEConfig as JVQ
from controlvar_tpu.eval import harness as jharness
from controlvar_tpu.models.control_var import ControlVARModel as JModel
from controlvar_tpu.models.vqvae import VQVAE as JVQVAE

import controlvar_tpu_torch.eval.stepwise as torch_stepwise
from controlvar_tpu_torch.ckpt.convert import from_jax_params, to_jax_params
from controlvar_tpu_torch.config import ControlVARConfig, SampleConfig, VQVAEConfig
from controlvar_tpu_torch.eval import SamplingHarness, class_shard
from controlvar_tpu_torch.eval.harness import _to_uint8
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.vqvae import VQVAE

from tests.torch_fixtures import one_torch_thread, raise_gates, vq_to_jax  # noqa: F401

TINY_VQ = dict(ch=32, patch_nums=(1, 2, 4), vocab_size=64)
TINY = dict(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 4), vocab_size=64,
            cvae=32, num_classes=6, mask_factor=2, multi_cond=True)
GREEDY = dict(cfg=(2.0, 2.0, 2.0), top_k=1)
# against JAX: two class directories, each one batch of 3 under a batch size
# of 4 (the ragged batch), so that each sampler compiles at one batch shape
FID = dict(batch_size=4, images_per_class=3, num_classes=2)
# the port alone: two batches a class (3 and a ragged 2) over four classes
FID_SHARDS = dict(batch_size=3, images_per_class=5, num_classes=4)


@pytest.fixture(scope="module")
def weights():
    """Both packages' models on one set of weights: numpy trees in the JAX
    layout (the port's init carried over, since the JAX VQVAE's eager init
    takes ~13 s here) for the JAX side, and `from_jax_params` of the same
    trees for the port."""
    cfg, vq_cfg = ControlVARConfig(**TINY), VQVAEConfig(**TINY_VQ)
    tm, tv = ControlVARModel(cfg, device="cpu"), VQVAE(vq_cfg, device="cpu")
    jp = raise_gates(to_jax_params(tm.init_params(1), cfg))
    jvp = vq_to_jax(tv.init_params(0))
    return dict(jm=JModel(JCfg(**TINY)), jv=JVQVAE(JVQ(**TINY_VQ)),
                jp=jax.tree_util.tree_map(jnp.asarray, jp),
                jvp=jax.tree_util.tree_map(jnp.asarray, jvp), tm=tm, tv=tv,
                tp=from_jax_params(jp, cfg, device="cpu"),
                tvp=from_jax_params(jvp, vq_cfg, device="cpu"))


def _port_harness(w, **kw):
    kw.setdefault("sample_cfg", SampleConfig(**GREEDY))
    return SamplingHarness(w["tm"], w["tv"], compute_dtype=torch.float32, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_fid(weights, tmp_path_factory):
    """{gibbs: (image count, {path: pixels})} of the JAX harness's
    generate_fid_set, one harness for both runs (the Gibbs run reuses the
    joint sampler's compiles)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jharness.SamplingHarness, "compute_dtype", jnp.float32)
        h = jharness.SamplingHarness(weights["jm"], weights["jv"], JSampleConfig(**GREEDY))
        out = {}
        for gibbs in (0, 1):
            d = tmp_path_factory.mktemp(f"jax_fid{gibbs}")
            n = h.generate_fid_set(weights["jp"], weights["jvp"], str(d), **FID, gibbs=gibbs)
            out[gibbs] = (n, _tree(d))
    return out


def _port_fid(w, out_dir, harness=None, **kw):
    h = harness or _port_harness(w)
    return h.generate_fid_set(h.prepare_params(w["tp"]), w["tvp"], str(out_dir), **kw)


def _tree(root):
    """{relative path: decoded pixels} of every PNG under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            out[os.path.relpath(path, root)] = np.asarray(Image.open(path).convert("RGB"))
    return out


def _assert_pixels_close(got, want):
    assert sorted(got) == sorted(want)
    g = np.stack([got[k] for k in sorted(got)]).astype(np.int16)
    w = np.stack([want[k] for k in sorted(want)]).astype(np.int16)
    diff = np.abs(g - w)
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()


@pytest.mark.parametrize("num_classes", [1, 4, 7, 10, 1000])
def test_class_shard_equals_jax(num_classes):
    for num_shards in range(1, min(num_classes, 8) + 1):
        got = [class_shard(num_classes, s, num_shards) for s in range(num_shards)]
        want = [jharness.class_shard(num_classes, s, num_shards) for s in range(num_shards)]
        assert got == want
        assert sum(got, []) == list(range(num_classes))


@pytest.mark.parametrize("gibbs", [0, 1])
def test_generate_fid_set_matches_jax(weights, jax_fid, tmp_path, gibbs):
    n_jax, want = jax_fid[gibbs]
    n_port = _port_fid(weights, tmp_path / "port", **FID, gibbs=gibbs)
    assert n_jax == n_port == 6
    got = _tree(tmp_path / "port")
    assert sorted(got) == [f"{c}/{i}.png" for c in range(2) for i in range(3)]
    assert all(v.shape == (64, 64, 3) for v in got.values())
    _assert_pixels_close(got, want)


def test_two_shards_equal_one_shard(weights, tmp_path):
    """Sampling (top-k 8, top-p 0.9), so each image depends on its draws:
    a run split into two shards writes the same files, bit for bit."""
    h = _port_harness(weights, sample_cfg=SampleConfig(cfg=(2.0, 2.0, 2.0), top_k=8, top_p=0.9))
    one = _port_fid(weights, tmp_path / "one", h, **FID_SHARDS)
    two = sum(_port_fid(weights, tmp_path / "two", h, **FID_SHARDS, shard_id=s, num_shards=2)
              for s in range(2))
    assert one == two == 20
    a, b = _tree(tmp_path / "one"), _tree(tmp_path / "two")
    assert sorted(a) == sorted(b) == sorted(f"{c}/{i}.png" for c in range(4) for i in range(5))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert sorted(os.listdir(tmp_path / "two")) == ["0", "1", "2", "3"]


def test_to_uint8_truncates_like_the_jax_package():
    """clip(img * 255, 0, 255) cast to uint8 in fp32: truncation, values
    outside [0, 1] clipped, as the JAX `_to_uint8`."""
    rng = np.random.default_rng(0)
    edges = [0.0, -0.0, 1.0, 0.5, 254.9 / 255, 1 / 255 - 1e-7, 1 / 255, 3 / 255]
    img = np.concatenate([rng.uniform(-0.5, 1.5, 3000), edges, np.arange(256) / 255]
                         ).astype(np.float32).reshape(1, -1, 1, 3)
    got = _to_uint8(torch.from_numpy(img))
    want = jharness._to_uint8(jnp.asarray(img))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_sampler_route_reaches_every_draw(weights, monkeypatch):
    """sampler="sort" sends every draw of the three samplers through the
    sort route, "auto" through the bisection route (K2 on the card); an
    unknown name is refused at construction."""
    methods = []
    orig = torch_stepwise.sample_top_k_top_p

    def spy(*args, method="auto", **kw):
        methods.append(method)
        return orig(*args, method=method, **kw)

    monkeypatch.setattr(torch_stepwise, "sample_top_k_top_p", spy)
    labels, ct = torch.tensor([1, 2]), torch.tensor([0, 3])
    img = torch.zeros(2, 64, 64, 3)
    for sampler in ("sort", "auto"):
        methods.clear()
        h = _port_harness(weights, sampler=sampler)
        p = h.prepare_params(weights["tp"])
        g = torch.Generator().manual_seed(0)
        h.joint(p, weights["tvp"], labels, ct, g)
        h.control_conditioned(p, weights["tvp"], labels, ct, g, img)
        h.image_conditioned(p, weights["tvp"], labels, ct, g, img)
        assert methods == [sampler] * 9
    with pytest.raises(ValueError, match="unknown sampler"):
        _port_harness(weights, sampler="nucleus")
