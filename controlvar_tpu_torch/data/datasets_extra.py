"""Additional condition-dataset families mirroring the reference's suite
(the port's copy of `controlvar_tpu/data/datasets_extra.py`): ImagenetM
(mask-only ImageNet), ImagenetS (semi-supervised segmentation), SA1B (SA-1B
masks, class-free), COCO and EntitySeg, and a plain ImageFolder
(reference: datasets/imagenetM.py, imagenetS.py, sa1b.py, coco.py,
entityS.py). All share the machinery of data/: numpy RLE decode, colormap
rendering, paired transforms. Files are decoded with PIL (and ImageNet-S's
connected components with cv2), imported inside the functions only.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from controlvar_tpu_torch.config import PATCH_NUMS_DEFAULT
from controlvar_tpu_torch.data.colormap import (ade_palette, grid_color_map,
                                               render_instance_mask)
from controlvar_tpu_torch.data.imagenetc import token_ignore_masks
from controlvar_tpu_torch.data.rle import decode_rle
from controlvar_tpu_torch.data.transforms import PairedTransform


def apply_color_map(id_map: np.ndarray, color_list: np.ndarray) -> np.ndarray:
    """Instance-id map -> color image via modulo palette indexing
    (reference: datasets/sa1b.py:13-28)."""
    idx = np.asarray(id_map) % len(color_list)
    return np.asarray(color_list, np.uint8)[idx]


def radial_sorted_instance_map(masks: Sequence[np.ndarray], size: int = 512) -> np.ndarray:
    """Stack binary instance masks sorted by centroid radius and argmax them
    into an id map (reference: datasets/sa1b.py:47-57)."""
    scored = []
    for m in masks:
        ys, xs = np.nonzero(m == 1)
        if len(xs) == 0:
            continue
        r = float(np.sqrt(np.mean(ys) ** 2 + np.mean(xs) ** 2))
        scored.append((r, m))
    if not scored:
        return np.zeros((size, size), np.int64)
    scored.sort(key=lambda t: t[0])
    return np.argmax(np.stack([m for _, m in scored]), axis=0)


def semantic_to_instance_map(semantic_png, colormap: Optional[np.ndarray] = None):
    """Semantic PNG (a PIL image) -> colorized instance map (a PIL image) via
    connected components sorted by centroid (reference:
    datasets/utils.py:135-166). cv2 host-side."""
    import cv2
    from PIL import Image

    if colormap is None:
        colormap = ade_palette()
    sem = np.asarray(semantic_png.convert("RGB"))
    category = (np.any(sem != 0, axis=-1).astype(np.uint8)) * 255
    num_labels, labels_im = cv2.connectedComponents(category)
    cents = []
    for label in range(1, num_labels):
        ys, xs = np.nonzero(labels_im == label)
        if len(xs) == 0:
            continue
        cents.append((label, float(np.mean(xs) + np.mean(ys))))
    cents.sort(key=lambda t: -t[1])
    out = np.zeros_like(sem)
    for idx, (label, _) in enumerate(cents, start=1):
        out[labels_im == label] = colormap[idx % len(colormap)]
    return Image.fromarray(out.astype(np.uint8))


def polygons_to_mask(polys: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    """COCO polygon segmentation -> binary mask (PIL rasterizer,
    replacing pycocotools; reference: datasets/coco.py polygon path)."""
    from PIL import Image, ImageDraw

    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in polys:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, np.uint8)


def _cond_sample(image, cond, cls: int,
                 transform: PairedTransform, rng,
                 patch_nums, cond_type: int = 0,
                 with_ignore: bool = True) -> Dict[str, np.ndarray]:
    cond = cond.resize(image.size)
    img_arr, cond_arr = transform(image, cond, rng=rng)
    if with_ignore:
        ign_mf, ign_if = token_ignore_masks(cond_arr, patch_nums)
    else:
        L = sum(pn * pn * 2 for pn in patch_nums)
        ign_mf = ign_if = np.ones((L,), np.float32)
    return {
        "image": img_arr, "mask": cond_arr, "cls": np.int32(cls),
        "type": np.int32(cond_type),
        "ignore_mask": ign_mf, "ignore_mask_": ign_if,
    }


@dataclasses.dataclass
class ImagenetMDataset:
    """Mask-only predecessor of ImagenetC (reference: datasets/imagenetM.py):
    one RLE-JSON mask per image under `{split}_mask/`."""

    root: str
    split: str = "train"
    image_size: int = 256
    patch_nums: Sequence[int] = PATCH_NUMS_DEFAULT

    def __post_init__(self):
        self.mask_paths = sorted(
            glob.glob(os.path.join(self.root, f"{self.split}_mask", "*", "*.json"))
        )
        classes = sorted(
            e.name for e in os.scandir(os.path.join(self.root, self.split)) if e.is_dir()
        )
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.colormap = grid_color_map()
        self.transform = PairedTransform(self.image_size, random_crop=self.split == "train")

    def __len__(self):
        return len(self.mask_paths)

    def sample(self, index: int, rng) -> Dict[str, np.ndarray]:
        from PIL import Image

        mask_path = self.mask_paths[index]
        image_path = mask_path.replace(f"{self.split}_mask", self.split).replace(".json", ".JPEG")
        cls = self.class_to_idx[os.path.basename(os.path.dirname(image_path))]
        image = Image.open(image_path).convert("RGB")
        with open(mask_path) as f:
            anns = json.load(f)
        cond = Image.fromarray(render_instance_mask(anns, 512, self.colormap).astype(np.uint8))
        return _cond_sample(image, cond, cls, self.transform, rng, self.patch_nums)


@dataclasses.dataclass
class ImagenetSDataset:
    """ImageNet-S semi-supervised segmentation (reference: datasets/imagenetS.py):
    semantic PNGs -> connected-component instance colormap."""

    root: str
    split: str = "train-semi"
    image_size: int = 256
    patch_nums: Sequence[int] = PATCH_NUMS_DEFAULT

    def __post_init__(self):
        self.image_paths = sorted(
            glob.glob(os.path.join(self.root, self.split, "*", "*.JPEG"))
        )
        self.mask_paths = sorted(
            glob.glob(os.path.join(self.root, f"{self.split}-segmentation", "*", "*.png"))
        )
        self.classes = sorted(
            {os.path.basename(os.path.dirname(p)) for p in self.image_paths}
        )
        self.transform = PairedTransform(self.image_size, random_crop=False)

    def __len__(self):
        return len(self.image_paths)

    def sample(self, index: int, rng) -> Dict[str, np.ndarray]:
        from PIL import Image

        image_path = self.image_paths[index]
        cls = self.classes.index(os.path.basename(os.path.dirname(image_path)))
        image = Image.open(image_path).convert("RGB")
        cond = semantic_to_instance_map(Image.open(self.mask_paths[index]))
        return _cond_sample(image, cond, cls, self.transform, rng, self.patch_nums,
                            with_ignore=False)


@dataclasses.dataclass
class SA1BDataset:
    """SA-1B masks (reference: datasets/sa1b.py): per-image annotation JSON of
    RLEs, radial-sorted argmax id map, class-free (cls=0)."""

    root: str
    image_size: int = 256
    patch_nums: Sequence[int] = PATCH_NUMS_DEFAULT

    def __post_init__(self):
        self.image_paths = sorted(glob.glob(os.path.join(self.root, "*", "*.jpg")))
        self.anno_paths = sorted(glob.glob(os.path.join(self.root, "*", "*.json")))
        self.colormap = ade_palette()
        self.transform = PairedTransform(self.image_size, random_crop=True)

    def __len__(self):
        return len(self.image_paths)

    def sample(self, index: int, rng) -> Dict[str, np.ndarray]:
        from PIL import Image

        image = Image.open(self.image_paths[index]).convert("RGB")
        with open(self.anno_paths[index]) as f:
            anns = json.load(f)["annotations"]
        masks = [decode_rle(a["segmentation"]) for a in anns]
        id_map = radial_sorted_instance_map(masks)
        cond = Image.fromarray(apply_color_map(id_map, self.colormap))
        return _cond_sample(image, cond, 0, self.transform, rng, self.patch_nums,
                            with_ignore=False)


@dataclasses.dataclass
class CocoMaskDataset:
    """COCO instance masks (reference: datasets/coco.py): polygon or RLE
    segmentations rendered to an id map, class-free conditioning."""

    annotation_path: str
    img_dir: str
    image_size: int = 256
    patch_nums: Sequence[int] = PATCH_NUMS_DEFAULT

    def __post_init__(self):
        with open(self.annotation_path) as f:
            coco = json.load(f)
        self.images = {im["id"]: im for im in coco["images"]}
        self.anns_by_img: Dict[int, list] = {}
        for ann in coco.get("annotations", []):
            self.anns_by_img.setdefault(ann["image_id"], []).append(ann)
        self.ids = sorted(self.anns_by_img)
        self.colormap = ade_palette()
        self.transform = PairedTransform(self.image_size, random_crop=True)

    def __len__(self):
        return len(self.ids)

    def sample(self, index: int, rng) -> Dict[str, np.ndarray]:
        from PIL import Image

        img_id = self.ids[index]
        info = self.images[img_id]
        h, w = info["height"], info["width"]
        image = Image.open(os.path.join(self.img_dir, info["file_name"])).convert("RGB")
        id_map = np.zeros((h, w), np.int64)
        for i, ann in enumerate(self.anns_by_img[img_id], start=1):
            seg = ann["segmentation"]
            if isinstance(seg, dict):
                m = decode_rle(seg)
            else:
                m = polygons_to_mask(seg, h, w)
            id_map[m.astype(bool)] = i
        cond = Image.fromarray(apply_color_map(id_map, self.colormap))
        return _cond_sample(image, cond, 0, self.transform, rng, self.patch_nums,
                            with_ignore=False)


@dataclasses.dataclass
class ImageFolderDataset:
    """Plain class-labelled ImageNet tree (no control stream) for the
    plain-VAR baseline trainer (reference: train_var_hpu.py uses a torchvision
    ImageFolder over ImageNet2012/train; configs/train_var_ImageNet_local.yaml).
    Emits {image, cls} only — exactly what VARTrainStep consumes."""

    root: str
    split: str = "train"
    image_size: int = 256

    def __post_init__(self):
        base = os.path.join(self.root, self.split)
        if not os.path.isdir(base):
            base = self.root  # allow pointing straight at the split dir
        classes = sorted(e.name for e in os.scandir(base) if e.is_dir())
        if not classes:
            raise FileNotFoundError(f"no class subdirectories under {base}")
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.image_paths = []
        for c in classes:
            for ext in ("*.JPEG", "*.jpg", "*.jpeg", "*.png"):
                self.image_paths.extend(glob.glob(os.path.join(base, c, ext)))
        self.image_paths.sort()
        self.transform = PairedTransform(self.image_size,
                                         random_crop=self.split == "train")

    def __len__(self):
        return len(self.image_paths)

    def sample(self, index: int, rng) -> Dict[str, np.ndarray]:
        from PIL import Image

        path = self.image_paths[index]
        cls = self.class_to_idx[os.path.basename(os.path.dirname(path))]
        image = Image.open(path).convert("RGB")
        img_arr, _ = self.transform(image, rng=rng)
        return {"image": img_arr, "cls": np.int32(cls)}
