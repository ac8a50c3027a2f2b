"""The port's token shards and tar shards against the JAX package's: a
shard written by either package reads back identically in the other, the
TokenShardLoader yields the JAX loader's batches, `pretokenize` on a tiny
VQVAE (fp32, the port's init carried to the JAX layout) writes the JAX
package's shards, and an id that int16 cannot hold raises. All bit for
bit."""
import glob
import io
import json
import os
import tarfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import controlvar_tpu.data.build as jbuild
import controlvar_tpu.data.imagenetc as jimagenetc
import controlvar_tpu.data.shards as jshards
from controlvar_tpu.config import VQVAEConfig as JVQ
from controlvar_tpu.models.vqvae import VQVAE as JVQVAE

import controlvar_tpu_torch.data.build as build
import controlvar_tpu_torch.data.imagenetc as imagenetc
import controlvar_tpu_torch.data.shards as shards
from controlvar_tpu_torch.config import VQVAEConfig
from controlvar_tpu_torch.models.vqvae import VQVAE

from tests.torch_fixtures import one_torch_thread, vq_to_jax  # noqa: F401

PNS = (1, 2, 4)


def _assert_shards_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], list):
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _shard_arrays(rng, B=3, ignore=True):
    ids = lambda: [rng.integers(0, 4096, (B, p * p)) for p in PNS]
    out = dict(ctrl_ids=ids(), img_ids=ids(), cls=rng.integers(0, 1000, (B,)),
               cond_type=rng.integers(0, 4, (B,)))
    out["ignore_mask"] = (rng.random((B, 46)) > 0.3).astype(np.float32) if ignore else None
    return out


@pytest.mark.parametrize("ignore", [True, False])
def test_shards_read_back_identically_in_either_package(tmp_path, rng, ignore):
    a = _shard_arrays(rng, ignore=ignore)
    shards.write_token_shard(str(tmp_path / "port.npz"), **a)
    jshards.write_token_shard(str(tmp_path / "jax.npz"), **a)
    for path in ("port.npz", "jax.npz"):
        got = shards.read_token_shard(str(tmp_path / path))
        _assert_shards_equal(got, jshards.read_token_shard(str(tmp_path / path)))
    port, jax_ = (shards.read_token_shard(str(tmp_path / p)) for p in ("port.npz", "jax.npz"))
    _assert_shards_equal(port, jax_)
    for want, got in zip(a["ctrl_ids"], port["ctrl_ids"]):
        np.testing.assert_array_equal(got, want)
    assert ("ignore_mask" in port) == ignore
    if ignore:
        np.testing.assert_array_equal(port["ignore_mask"], a["ignore_mask"])


def test_ids_beyond_int16_raise(tmp_path, rng):
    a = _shard_arrays(rng)
    a["img_ids"][1][0, 0] = 32768
    with pytest.raises(ValueError, match="32768"):
        shards.write_token_shard(str(tmp_path / "x.npz"), **a)
    a["img_ids"][1][0, 0] = 32767
    shards.write_token_shard(str(tmp_path / "x.npz"), **a)
    assert int(shards.read_token_shard(str(tmp_path / "x.npz"))["img_ids"][1][0, 0]) == 32767
    a["ctrl_ids"][0][0, 0] = -1
    with pytest.raises(ValueError, match="32768"):
        shards.write_token_shard(str(tmp_path / "y.npz"), **a)


@pytest.mark.parametrize("shard_id,num_shards,skip", [(0, 1, 0), (1, 2, 1), (2, 3, 0)])
def test_token_shard_loader_matches_jax(tmp_path, rng, shard_id, num_shards, skip):
    for i in range(7):
        jshards.write_token_shard(str(tmp_path / f"tokens_000_{i:06d}.npz"),
                                  **_shard_arrays(rng, B=2))
    pattern = str(tmp_path / "tokens_*.npz")
    kw = dict(seed=3, shard_id=shard_id, num_shards=num_shards)
    loader, jloader = shards.TokenShardLoader(pattern, **kw), jshards.TokenShardLoader(pattern,
                                                                                       **kw)
    assert loader.steps_per_epoch() == jloader.steps_per_epoch()
    for epoch in (0, 1):
        got, want = list(loader.epoch(epoch, skip)), list(jloader.epoch(epoch, skip))
        assert len(got) == len(want) == loader.steps_per_epoch() - skip
        for a, b in zip(got, want):
            _assert_shards_equal(a, b)
    assert len(shards.TokenShardDataset(pattern)) == 7
    _assert_shards_equal(next(iter(shards.TokenShardDataset(pattern))),
                         next(iter(jshards.TokenShardDataset(pattern))))
    with pytest.raises(FileNotFoundError):
        shards.TokenShardLoader(str(tmp_path / "none_*.npz"))


def test_pretokenize_writes_the_jax_packages_shards(tmp_path):
    """Both packages tokenize the same Loader batches (a separator-layout
    synthetic dataset, so the shards carry its ignore masks) with the same
    tiny VQVAE in fp32: the same shard files, id for id, and the ids equal
    the port's img_to_ids of the batches."""
    import torch

    vq_kw = dict(ch=32, patch_nums=PNS, vocab_size=128)
    tv = VQVAE(VQVAEConfig(**vq_kw), device="cpu")
    tvp = tv.init_params(0)
    ds_kw = dict(image_size=64, num_classes=10, patch_nums=PNS, separator=True, length=6)
    loader = build.Loader(imagenetc.SyntheticControlDataset(**ds_kw), batch_size=2, seed=1,
                          num_workers=2)
    n = shards.pretokenize(tv, tvp, loader, str(tmp_path / "port"), epochs=(0, 1),
                           compute_dtype=torch.float32)
    jloader = jbuild.Loader(jimagenetc.SyntheticControlDataset(**ds_kw), batch_size=2, seed=1,
                            num_workers=1)
    jvp = jax.tree_util.tree_map(jnp.asarray, vq_to_jax(tvp))
    jn = jshards.pretokenize(JVQVAE(JVQ(**vq_kw)), jvp, jloader, str(tmp_path / "jax"),
                             epochs=(0, 1), compute_dtype=jnp.float32)
    assert n == jn == 6
    names = sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "port" / "*.npz")))
    assert names == sorted(os.path.basename(p)
                           for p in glob.glob(str(tmp_path / "jax" / "*.npz")))
    for name in names:
        _assert_shards_equal(shards.read_token_shard(str(tmp_path / "port" / name)),
                             jshards.read_token_shard(str(tmp_path / "jax" / name)))
    first = shards.read_token_shard(str(tmp_path / "port" / names[0]))
    batch = next(iter(loader.epoch(0)))
    want = tv.img_to_ids(tvp, torch.from_numpy(batch["mask"]))
    for a, b in zip(first["ctrl_ids"], want):
        np.testing.assert_array_equal(a, b.numpy())
    assert first["ignore_mask"].shape == (2, 2 * 21 + 4)


def test_tar_shard_reader_matches_jax(tmp_path, rng):
    from PIL import Image

    with tarfile.open(tmp_path / "train-000.tar", "w") as tf:
        for i in range(3):
            for suffix in ("image.png", "control.png"):
                buf = io.BytesIO()
                Image.fromarray((rng.random((40, 50, 3)) * 255).astype(np.uint8)).save(
                    buf, format="PNG")
                info = tarfile.TarInfo(f"s{i}.{suffix}")
                info.size = len(buf.getvalue())
                tf.addfile(info, io.BytesIO(buf.getvalue()))
            meta = json.dumps({"cls": i, "type": 2}).encode()
            info = tarfile.TarInfo(f"s{i}.json")
            info.size = len(meta)
            tf.addfile(info, io.BytesIO(meta))
    pattern = str(tmp_path / "train-*.tar")
    for random_crop in (False, True):
        got = list(shards.TarShardReader(pattern, image_size=32, random_crop=random_crop))
        want = list(jshards.TarShardReader(pattern, image_size=32, random_crop=random_crop))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
