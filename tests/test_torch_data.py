"""The port's data layer against the JAX package's: the RLE codec and the
native library, the colormaps and mask rendering, the token ignore masks,
the paired transform, every dataset on a tiny tree written here, and the
threaded Loader; all bit for bit (the same numpy and PIL code paths on the
same files and seeds). The Loader tests run their epochs under a deadline,
so that a hung worker fails the test instead of the suite's time limit."""
import json
import threading
import time

import numpy as np
import pytest
import torch

import controlvar_tpu.data.build as jbuild
import controlvar_tpu.data.colormap as jcolormap
import controlvar_tpu.data.datasets_extra as jextra
import controlvar_tpu.data.imagenetc as jimagenetc
import controlvar_tpu.data.rle as jrle
import controlvar_tpu.data.transforms as jtransforms
from controlvar_tpu import native as jnative

import controlvar_tpu_torch.data.build as build
import controlvar_tpu_torch.data.colormap as colormap
import controlvar_tpu_torch.data.datasets_extra as extra
import controlvar_tpu_torch.data.imagenetc as imagenetc
import controlvar_tpu_torch.data.rle as rle
import controlvar_tpu_torch.data.transforms as transforms
from controlvar_tpu_torch import native

from tests.torch_fixtures import one_torch_thread  # noqa: F401

PNS = (1, 2, 3, 4, 5, 6)   # scales >= 5 take the mask-derived weights


def _assert_samples_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _deadline(fn, seconds=60.0):
    """fn() in a daemon thread; fails the test if it has not returned within
    `seconds` (a hung loader), re-raises what it raised."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as exc:  # noqa: BLE001 - handed to the test
            out["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail(f"did not finish within {seconds} s (a hung loader)")
    if "error" in out:
        raise out["error"]
    return out["value"]


def _instance_masks(rng, n, size=512):
    """n random rectangles as COCO annotations (string RLEs), some below the
    5000-pixel area cut."""
    anns = []
    for _ in range(n):
        m = np.zeros((size, size), np.uint8)
        y, x = rng.integers(0, size - 40, 2)
        h, w = rng.integers(10, size // 2, 2)
        m[y: y + h, x: x + w] = 1
        anns.append({"area": float(m.sum()), "segmentation": jrle.encode_rle(m)})
    return anns


# ---- RLE, native, colormaps -------------------------------------------------

def test_rle_codec_matches_jax(rng):
    for shape in ((37, 53), (64, 64), (1, 9)):
        m = (rng.random(shape) > 0.6).astype(np.uint8)
        enc = rle.encode_rle(m)
        assert enc == jrle.encode_rle(m)
        np.testing.assert_array_equal(rle.decode_rle(enc), jrle.decode_rle(enc))
        np.testing.assert_array_equal(rle.decode_rle(enc), m)
    counts = {"size": [2, 3], "counts": [2, 3, 1]}
    np.testing.assert_array_equal(rle.decode_rle(counts), jrle.decode_rle(counts))
    assert rle._counts_from_string(enc["counts"]) == jrle._counts_from_string(enc["counts"])


def test_native_library_matches_jax_and_builds_outside_the_package(rng):
    assert native.available() and jnative.available()
    assert "build/native" in native._target().replace("\\", "/")
    m = (rng.random((200, 300)) > 0.5).astype(np.uint8)
    counts = jrle.encode_rle(m)["counts"]
    np.testing.assert_array_equal(native.rle_decode(counts, 200, 300),
                                  jnative.rle_decode(counts, 200, 300))
    np.testing.assert_array_equal(native.rle_decode(counts, 200, 300), m)
    anns = _instance_masks(rng, 6)
    cmap = colormap.grid_color_map()
    np.testing.assert_array_equal(native.render_mask(anns, 512, cmap),
                                  jnative.render_mask(anns, 512, cmap))
    mixed = anns + [{"area": 9e9, "segmentation": {"size": [64, 64], "counts": [0, 4096]}}]
    assert native.render_mask(mixed, 512, cmap) is None


def test_colormaps_and_rendering_match_jax(rng):
    np.testing.assert_array_equal(colormap.grid_color_map(), jcolormap.grid_color_map())
    np.testing.assert_array_equal(colormap.ade_palette(), jcolormap.ade_palette())
    anns = _instance_masks(rng, 5)
    for use_native in (True, False):
        got = colormap.render_instance_mask(anns, 512, use_native=use_native)
        want = jcolormap.render_instance_mask(anns, 512, use_native=use_native)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(colormap.render_instance_mask(anns, 512, use_native=True),
                                  colormap.render_instance_mask(anns, 512, use_native=False))


def test_render_falls_back_to_numpy_on_a_malformed_rle(monkeypatch):
    """More counts than h * w + 2: the native parser returns -2 and raises;
    both packages then take the numpy path and return the same mask. So do
    they when the native library fails to load."""
    anns = [{"segmentation": {"size": [16, 16], "counts": "0" * 300}, "area": 1e9}]
    with pytest.raises(ValueError, match="rc=-2"):
        native.render_mask(anns, 16, colormap.grid_color_map(), 0)
    got = colormap.render_instance_mask(anns, 16, min_area=0)
    want = jcolormap.render_instance_mask(anns, 16, min_area=0)
    assert got.shape == (16, 16, 3) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)

    def broken(*args, **kwargs):
        raise OSError("cannot load the native library")

    monkeypatch.setattr(native, "available", broken)
    good = [{"segmentation": jrle.encode_rle(np.eye(16, dtype=np.uint8)), "area": 1e9}]
    np.testing.assert_array_equal(colormap.render_instance_mask(good, 16, min_area=0),
                                  jcolormap.render_instance_mask(good, 16, min_area=0))


@pytest.mark.parametrize("separator", [False, True])
def test_token_ignore_masks_match_jax(rng, separator):
    cond = rng.random((64, 64, 3)).astype(np.float32) * 2 - 1
    cond[:20, :30] = -1.0   # black: unlabeled background
    got = imagenetc.token_ignore_masks(cond, PNS, separator)
    want = jimagenetc.token_ignore_masks(cond, PNS, separator)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    L = 2 * sum(p * p for p in PNS) + (2 * (len(PNS) - 1) if separator else 0)
    assert got[0].shape == (L,) and (got[0] == 0).any() and not np.array_equal(*got)


@pytest.mark.parametrize("random_crop", [False, True])
def test_paired_transform_matches_jax(rng, random_crop):
    from PIL import Image

    img = Image.fromarray((rng.random((90, 120, 3)) * 255).astype(np.uint8))
    ctl = Image.fromarray((rng.random((90, 120, 3)) * 255).astype(np.uint8))
    got = transforms.PairedTransform(64, random_crop)(img, ctl, rng=np.random.default_rng(3))
    want = jtransforms.PairedTransform(64, random_crop)(img, ctl, rng=np.random.default_rng(3))
    for a, b in zip(got, want):
        assert a.shape == (64, 64, 3)
        np.testing.assert_array_equal(a, b)
    alone = transforms.PairedTransform(64)(img)
    assert alone[1] is None
    np.testing.assert_array_equal(alone[0], jtransforms.PairedTransform(64)(img)[0])


# ---- datasets on tiny trees ---------------------------------------------------

def _save(arr, path):
    from PIL import Image

    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)


def _img(rng, h=48, w=56):
    return (rng.random((h, w, 3)) * 255).astype(np.uint8)


def _imagenetc_tree(root, rng):
    for ci, cls in enumerate(("n001", "n002")):
        for j in range(2):
            stem = f"img_{ci}{j}"
            _save(_img(rng), root / "train" / cls / f"{stem}.JPEG")
            for cond in ("canny", "depth", "normal"):
                _save(_img(rng), root / f"train_{cond}" / cls / f"{stem}.jpeg")
            (root / "train_mask" / cls).mkdir(parents=True, exist_ok=True)
            with open(root / "train_mask" / cls / f"{stem}.json", "w") as f:
                json.dump(_instance_masks(rng, 3), f)


def _imagenets_tree(root, rng):
    for cls in ("n001", "n002"):
        for j in range(2):
            _save(_img(rng), root / "train-semi" / cls / f"i{j}.JPEG")
            sem = np.zeros((48, 56, 3), np.uint8)
            sem[5:20, 5:25] = 200
            sem[30:44, 30:50] = 90
            _save(sem, root / "train-semi-segmentation" / cls / f"i{j}.png")


def _sa1b_tree(root, rng):
    d = root / "sa_000"
    for j in range(2):
        _save(_img(rng, 64, 64), d / f"sa_{j}.jpg")
        anns = []
        for y in (4, 30):
            m = np.zeros((512, 512), np.uint8)
            m[y * 8: y * 8 + 100, 50:200] = 1
            anns.append({"segmentation": jrle.encode_rle(m)})
        with open(d / f"sa_{j}.json", "w") as f:
            json.dump({"annotations": anns}, f)


def _coco_tree(root, rng):
    _save(_img(rng, 40, 50), root / "img" / "a.jpg")
    _save(_img(rng, 40, 50), root / "img" / "b.jpg")
    m = np.zeros((40, 50), np.uint8)
    m[5:20, 10:30] = 1
    coco = {"images": [{"id": 1, "file_name": "a.jpg", "height": 40, "width": 50},
                       {"id": 2, "file_name": "b.jpg", "height": 40, "width": 50}],
            "annotations": [{"image_id": 1, "segmentation": jrle.encode_rle(m)},
                            {"image_id": 1, "segmentation": [[30, 5, 45, 5, 45, 30, 30, 30]]},
                            {"image_id": 2, "segmentation": [[2, 2, 20, 2, 10, 25]]}]}
    with open(root / "coco.json", "w") as f:
        json.dump(coco, f)


def _imagefolder_tree(root, rng):
    for cls in ("n01", "n02"):
        for j in range(2):
            _save(_img(rng), root / "train" / cls / f"x{j}.JPEG")


# dataset: (tree writer, port class, JAX class, constructor arguments given the root)
DATASETS = {
    "imagenetc": (_imagenetc_tree, imagenetc.ImagenetCDataset, jimagenetc.ImagenetCDataset,
                  lambda r: dict(root=str(r), image_size=32, patch_nums=PNS)),
    "imagenetc-separator-random-crop": (
        _imagenetc_tree, imagenetc.ImagenetCDataset, jimagenetc.ImagenetCDataset,
        lambda r: dict(root=str(r), image_size=32, patch_nums=PNS, separator=True,
                       random_crop=True)),
    "imagenets": (_imagenets_tree, extra.ImagenetSDataset, jextra.ImagenetSDataset,
                  lambda r: dict(root=str(r), image_size=32, patch_nums=PNS)),
    "sa1b": (_sa1b_tree, extra.SA1BDataset, jextra.SA1BDataset,
             lambda r: dict(root=str(r), image_size=32, patch_nums=PNS)),
    "coco": (_coco_tree, extra.CocoMaskDataset, jextra.CocoMaskDataset,
             lambda r: dict(annotation_path=str(r / "coco.json"), img_dir=str(r / "img"),
                            image_size=32, patch_nums=PNS)),
    "imagefolder": (_imagefolder_tree, extra.ImageFolderDataset, jextra.ImageFolderDataset,
                    lambda r: dict(root=str(r), image_size=32)),
}


@pytest.mark.parametrize("name", list(DATASETS))
def test_dataset_samples_match_jax(tmp_path, rng, name):
    write, cls, jcls, kwargs = DATASETS[name]
    write(tmp_path, rng)
    got_ds, want_ds = cls(**kwargs(tmp_path)), jcls(**kwargs(tmp_path))
    assert len(got_ds) == len(want_ds) >= 2
    for i in range(len(got_ds)):
        _assert_samples_equal(got_ds.sample(i, np.random.default_rng((5, i))),
                              want_ds.sample(i, np.random.default_rng((5, i))))


def test_imagenetm_dataset_matches_jax(tmp_path, rng):
    for cls in ("n001", "n002"):
        _save(_img(rng), tmp_path / "train" / cls / "a.JPEG")
        (tmp_path / "train_mask" / cls).mkdir(parents=True)
        with open(tmp_path / "train_mask" / cls / "a.json", "w") as f:
            json.dump(_instance_masks(rng, 2), f)
    kw = dict(root=str(tmp_path), image_size=32, patch_nums=PNS)
    got, want = extra.ImagenetMDataset(**kw), jextra.ImagenetMDataset(**kw)
    for i in range(2):
        _assert_samples_equal(got.sample(i, np.random.default_rng(i)),
                              want.sample(i, np.random.default_rng(i)))


def test_dataset_helpers_match_jax(rng):
    ids = rng.integers(0, 300, (20, 30))
    np.testing.assert_array_equal(extra.apply_color_map(ids, colormap.ade_palette()),
                                  jextra.apply_color_map(ids, jcolormap.ade_palette()))
    ms = [(rng.random((32, 32)) > 0.7).astype(np.uint8) for _ in range(3)]
    np.testing.assert_array_equal(extra.radial_sorted_instance_map(ms, 32),
                                  jextra.radial_sorted_instance_map(ms, 32))
    poly = [[2.0, 2.0, 20.0, 3.0, 12.0, 25.0]]
    np.testing.assert_array_equal(extra.polygons_to_mask(poly, 30, 30),
                                  jextra.polygons_to_mask(poly, 30, 30))


@pytest.mark.parametrize("separator", [False, True])
def test_synthetic_dataset_matches_jax(separator):
    kw = dict(image_size=32, num_classes=10, patch_nums=PNS, separator=separator, length=5)
    got, want = imagenetc.SyntheticControlDataset(**kw), jimagenetc.SyntheticControlDataset(**kw)
    for i in range(5):
        _assert_samples_equal(got.sample(i, np.random.default_rng(i)),
                              want.sample(i, np.random.default_rng(i)))
    L = 2 * sum(p * p for p in PNS) + (10 if separator else 0)
    assert got.sample(0, np.random.default_rng(0))["ignore_mask"].shape == (L,)


def test_create_dataset_dispatches_every_name_to_the_ports_class(monkeypatch):
    ds = build.create_dataset("synthetic", image_size=32, length=8)
    assert type(ds) is imagenetc.SyntheticControlDataset and len(ds) == 8
    with pytest.raises(NotImplementedError):
        build.create_dataset("nonexistent")
    names = {"imagenetC": (imagenetc, "ImagenetCDataset"),
             "imagenet_m": (extra, "ImagenetMDataset"), "imagenetS": (extra, "ImagenetSDataset"),
             "sa1b": (extra, "SA1BDataset"), "imagenet": (extra, "ImageFolderDataset"),
             "imagefolder": (extra, "ImageFolderDataset"), "coco": (extra, "CocoMaskDataset"),
             "entityS": (extra, "CocoMaskDataset")}
    for name, (module, attr) in names.items():
        monkeypatch.setattr(module, attr, lambda attr=attr, **kw: (attr, kw))
        assert build.create_dataset(name, root="r") == (attr, {"root": "r"}), name


# ---- Loader -------------------------------------------------------------------

@pytest.mark.parametrize("shard_id,num_shards,skip", [(0, 1, 0), (1, 2, 0), (0, 3, 2)])
def test_loader_batches_match_jax(shard_id, num_shards, skip):
    """The same seed, shard and skip give the JAX Loader's batches bit for
    bit, with any worker count (per-sample rngs)."""
    kw = dict(image_size=16, num_classes=10, patch_nums=(1, 2, 4), separator=True, length=37)
    args = dict(batch_size=4, seed=11, shard_id=shard_id, num_shards=num_shards)
    got = _deadline(lambda: list(build.Loader(imagenetc.SyntheticControlDataset(**kw),
                                              num_workers=3, **args).epoch(2, skip)))
    want = list(jbuild.Loader(jimagenetc.SyntheticControlDataset(**kw), num_workers=1,
                              **args).epoch(2, skip))
    assert len(got) == len(want) == build.Loader(
        imagenetc.SyntheticControlDataset(**kw), **args).steps_per_epoch() - skip
    for a, b in zip(got, want):
        _assert_samples_equal(a, b)


def test_loader_raises_a_worker_error_to_the_caller():
    class Exploding(imagenetc.SyntheticControlDataset):
        def sample(self, index, rng):
            if index == 9:
                raise ValueError("corrupt file at index 9")
            return super().sample(index, rng)

    loader = build.Loader(Exploding(image_size=16, length=32, patch_nums=(1, 2)), batch_size=4,
                          shuffle=False, num_workers=4, prefetch=1)
    before = threading.active_count()

    def drain():
        with pytest.raises(RuntimeError, match="worker failed") as ei:
            for _ in loader.epoch(0):
                pass
        return ei.value

    err = _deadline(drain, 30.0)
    assert isinstance(err.__cause__, ValueError)
    for _ in range(50):   # every worker thread released
        if threading.active_count() <= before:
            break
        time.sleep(0.1)
    assert threading.active_count() <= before


def test_to_device_copies_batches_and_id_lists():
    ds = imagenetc.SyntheticControlDataset(image_size=16, length=8, patch_nums=(1, 2))
    batch = next(iter(build.Loader(ds, batch_size=2, num_workers=1).epoch(0)))
    batch["ids"] = [np.arange(4, dtype=np.int32).reshape(2, 2)]
    out = build.to_device(batch, "cpu")
    assert isinstance(out["image"], torch.Tensor) and out["image"].dtype == torch.float32
    np.testing.assert_array_equal(out["image"].numpy(), batch["image"])
    assert out["cls"].dtype == torch.int32 and isinstance(out["ids"], list)
    t = torch.ones(3)
    assert build.to_device({"t": t}, "cpu")["t"] is t
