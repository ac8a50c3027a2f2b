"""ImageNet-with-conditions dataset (the primary ControlVAR training set)
and its synthetic stand-in (the port's copy of
`controlvar_tpu/data/imagenetc.py`).

Pseudo-labeled ImageNet where every image has 4 condition renderings: an
instance mask (COCO-RLE JSON -> colorized), canny / depth / normal JPEGs,
in sibling directories `{split}_{cond}/` mirroring `{split}/`
(reference: datasets/imagenetC.py, README.md:36-48).

Host-side numpy; samples are NHWC float32. The per-token ignore mask zeroes
the loss on black mask regions at scales >= 5 in both the mask-first and
the image-first order (reference: imagenetC.py:152-183). The file-backed
dataset decodes with PIL, imported inside its methods only: the synthetic
dataset runs without PIL.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from controlvar_tpu_torch.config import COND_TYPES, PATCH_NUMS_DEFAULT
from controlvar_tpu_torch.data.colormap import grid_color_map, render_instance_mask
from controlvar_tpu_torch.data.transforms import PairedTransform

COND_IDX = {"mask": 0, "canny": 1, "depth": 2, "normal": 3}


def _nearest_downsample(m: np.ndarray, out: int) -> np.ndarray:
    """torch F.interpolate(mode='nearest') semantics: src = floor(i*n/out)."""
    n = m.shape[0]
    idx = np.minimum((np.arange(out) * n / out).astype(np.int64), n - 1)
    return m[np.ix_(idx, idx)]


def token_ignore_masks(
    cond_img: np.ndarray,
    patch_nums: Sequence[int] = PATCH_NUMS_DEFAULT,
    separator: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-token loss weights from a normalized control image (H, W, 3).

    Black pixels (normalized sum == -3) are unlabeled background: their
    mask-segment tokens at scales >= 5 are zero-weighted. Returns
    (mask_first_weights, image_first_weights), each (L,) float32.
    """
    ignore = (cond_img.sum(axis=-1) != -3.0).astype(np.float32)  # (H, W)
    out_mf: List[np.ndarray] = []
    out_if: List[np.ndarray] = []
    for si, pn in enumerate(patch_nums):
        num_sp = 1 if (si != 0 and separator) else 0
        ones = np.ones((pn * pn + num_sp,), np.float32)
        if si < 5:
            out_mf.extend([ones, ones])
            out_if.extend([ones, ones])
        else:
            ds = _nearest_downsample(ignore, pn).reshape(-1)
            if separator:
                ds = np.concatenate([np.ones((1,), np.float32), ds])
            out_mf.extend([ds, ones])
            out_if.extend([ones, ds])
    return np.concatenate(out_mf), np.concatenate(out_if)


@dataclasses.dataclass
class ImagenetCDataset:
    """Index-addressable sample source (wrap in data.build.Loader to batch)."""

    root: str
    split: str = "train"
    image_size: int = 256
    patch_nums: Sequence[int] = PATCH_NUMS_DEFAULT
    separator: bool = False
    val_cond: str = "depth"
    random_crop: Optional[bool] = None  # default: train=True, val=False
    scan_corrupt: bool = False  # first-run content scan (parse JSON / decode
                                # headers), like the reference's corrupt-file
                                # scan (reference: imagenetC.py:75-122)

    _COND_EXT = {"mask": "json", "canny": "jpeg", "depth": "jpeg", "normal": "jpeg"}

    def __post_init__(self):
        classes = sorted(
            e.name for e in os.scandir(os.path.join(self.root, self.split)) if e.is_dir()
        )
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self._load_records()
        self.colormap = grid_color_map()
        self.transform = PairedTransform(
            self.image_size,
            random_crop=(self.split == "train") if self.random_crop is None else self.random_crop,
        )

    def _load_records(self):
        """Build (or load) the JOINT pairing cache: one record per image with
        the per-condition paths that actually exist, keyed by file stem — a
        missing or corrupt condition file drops only ITS entry instead of
        shifting every subsequent pairing the way index-arithmetic over four
        independently-globbed lists would (the reference validates pairings
        through the same kind of joint info cache, imagenetC.py:75-122)."""
        cache = os.path.join(self.root, f"{self.split}_cond_info.json")
        if os.path.exists(cache):
            with open(cache) as f:
                info = json.load(f)
            if isinstance(info, dict) and info.get("version") == 2:
                self.records = info["records"]
                return
            # stale v1 cache (independent per-type lists): rebuild
        image_paths = sorted(
            glob.glob(os.path.join(self.root, self.split, "*", "*.JPEG"))
        )
        records = []
        dropped = 0
        for img in image_paths:
            cls_dir = os.path.basename(os.path.dirname(img))
            stem = os.path.splitext(os.path.basename(img))[0]
            rec = {"image": img, "cls": cls_dir}
            for cond, ext in self._COND_EXT.items():
                p = os.path.join(
                    self.root, f"{self.split}_{cond}", cls_dir, f"{stem}.{ext}"
                )
                if not os.path.exists(p):
                    continue
                if self.scan_corrupt and not self._readable(cond, p):
                    dropped += 1
                    continue
                rec[cond] = p
            if any(c in rec for c in self._COND_EXT):
                records.append(rec)
        if dropped:
            print(f"[imagenetC] dropped {dropped} corrupt condition files")
        self.records = records
        try:
            with open(cache, "w") as f:
                json.dump({"version": 2, "records": records}, f)
        except OSError:
            pass  # read-only dataset root: skip caching

    @staticmethod
    def _readable(cond: str, path: str) -> bool:
        from PIL import Image

        try:
            if cond == "mask":
                with open(path) as f:
                    json.load(f)
            else:
                with Image.open(path) as im:
                    im.verify()
            return True
        except Exception:
            return False

    def __len__(self) -> int:
        return len(self.records)

    def sample(self, index: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        from PIL import Image

        rec = self.records[index % len(self.records)]
        if self.split == "val":
            cond_type = self.val_cond
        else:
            cond_type = COND_TYPES[int(rng.integers(0, 4))]
        if cond_type not in rec:  # that condition is missing for this image:
            # fall back to one that exists (deterministic order)
            cond_type = next(c for c in COND_TYPES if c in rec)
        cond_path = rec[cond_type]
        image_path = rec["image"]
        cls = self.class_to_idx[rec["cls"]]
        image = Image.open(image_path).convert("RGB")

        if cond_type == "mask":
            with open(cond_path) as f:
                anns = json.load(f)
            # 512 is the fixed labelling resolution (reference: imagenetC.py:143)
            cond = Image.fromarray(
                render_instance_mask(anns, 512, self.colormap).astype(np.uint8)
            )
        else:
            cond = Image.open(cond_path).convert("RGB")
        cond = cond.resize(image.size)

        img_arr, cond_arr = self.transform(image, cond, rng=rng)

        if cond_type == "mask":
            ign_mf, ign_if = token_ignore_masks(cond_arr, self.patch_nums, self.separator)
        else:
            L = sum(pn * pn * 2 for pn in self.patch_nums)
            if self.separator:
                L += (len(self.patch_nums) - 1) * 2
            ign_mf = np.ones((L,), np.float32)
            ign_if = np.ones((L,), np.float32)

        return {
            "image": img_arr,
            "mask": cond_arr,
            "cls": np.int32(cls),
            "type": np.int32(COND_IDX[cond_type]),
            "ignore_mask": ign_mf,
            "ignore_mask_": ign_if,
        }


@dataclasses.dataclass
class SyntheticControlDataset:
    """Random-data stand-in with the same sample schema (tests, benches,
    smoke training without the 400 GB condition dataset)."""

    image_size: int = 256
    num_classes: int = 1000
    patch_nums: Sequence[int] = PATCH_NUMS_DEFAULT
    separator: bool = False
    length: int = 10000

    def __len__(self):
        return self.length

    def sample(self, index: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        hw = self.image_size
        L = sum(pn * pn * 2 for pn in self.patch_nums)
        if self.separator:
            L += (len(self.patch_nums) - 1) * 2
        return {
            "image": rng.random((hw, hw, 3), np.float32) * 2 - 1,
            "mask": rng.random((hw, hw, 3), np.float32) * 2 - 1,
            "cls": np.int32(rng.integers(0, self.num_classes)),
            "type": np.int32(rng.integers(0, 4)),
            "ignore_mask": np.ones((L,), np.float32),
            "ignore_mask_": np.ones((L,), np.float32),
        }
