"""Paired image+control transforms on the host (the port's copy of
`controlvar_tpu/data/transforms.py`).

The image and its control map get IDENTICAL parameters: a Lanczos resize
of the shorter side to round(1.125 * size), a random (train) or center crop
to size, a random horizontal flip (train), then [-1, 1] float32 NHWC
arrays. The images are PIL images; PIL is imported inside the functions
only, so that this module imports on a machine without it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


def _resize_shorter(img, size: int):
    from PIL import Image

    w, h = img.size
    if w <= h:
        new = (size, max(1, round(h * size / w)))
    else:
        new = (max(1, round(w * size / h)), size)
    return img.resize(new, Image.LANCZOS)


def _to_array(img) -> np.ndarray:
    arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    return arr * 2.0 - 1.0  # Normalize(mean=.5, std=.5)


@dataclasses.dataclass
class PairedTransform:
    image_size: int = 256
    random_crop: bool = False  # True for train, False for val
    flip_prob: float = 0.5
    mid_res: float = 1.125

    def __call__(self, image, control=None, rng: Optional[np.random.Generator] = None
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        from PIL import Image

        rng = rng or np.random.default_rng()
        size = self.image_size
        mid = round(self.mid_res * size)
        image = _resize_shorter(image, mid)
        if control is not None:
            control = _resize_shorter(control, mid)
        w, h = image.size
        if self.random_crop:
            top = int(rng.integers(0, h - size + 1))
            left = int(rng.integers(0, w - size + 1))
        else:
            top = (h - size) // 2
            left = (w - size) // 2
        box = (left, top, left + size, top + size)
        image = image.crop(box)
        if control is not None:
            control = control.crop(box)
        if self.random_crop and rng.random() < self.flip_prob:
            image = image.transpose(Image.FLIP_LEFT_RIGHT)
            if control is not None:
                control = control.transpose(Image.FLIP_LEFT_RIGHT)
        return _to_array(image), None if control is None else _to_array(control)


def read_image(path: str, image_size: int) -> np.ndarray:
    """The image file at `path` as the CLI reads it: converted to RGB, then
    `PairedTransform(image_size, random_crop=False)`; (H, W, 3) float32 in
    [-1, 1]. Exits naming PIL where PIL is not installed (the GPU machine
    has none)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise SystemExit(f"reading {path} requires PIL (Pillow, not installed)") from e
    image, _ = PairedTransform(image_size, random_crop=False)(Image.open(path).convert("RGB"))
    return image
