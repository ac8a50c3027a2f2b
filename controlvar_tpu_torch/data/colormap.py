"""Instance-mask colorization (the port's copy of
`controlvar_tpu/data/colormap.py`).

The pseudo-label masks are rendered as COLOR images before tokenization: each
instance gets a color from a 124-entry grid over the 5-level RGB cube (black
removed), selected by the instance centroid's cell in an 11x11 grid
(reference: datasets/imagenetC.py:15-37).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from controlvar_tpu_torch.data.rle import decode_rle


def grid_color_map() -> np.ndarray:
    """(124, 3) uint8: 5^3 RGB grid minus black (reference: imagenetC.py:31-37)."""
    levels = [0, 64, 128, 192, 255]
    cmap = [[r, g, b] for r in levels for g in levels for b in levels]
    return np.array(cmap[1:], dtype=np.int64)


def ade_palette() -> np.ndarray:
    """(151, 3) int64 ADE20K-style palette, row 0 = black background — the
    reference's hand-written table, ported verbatim as a constant
    (reference: datasets/color_map.py; duplicated in datasets/mask_color.py).
    Consumers index instances from 1 so background stays black."""
    return np.array(_ADE_TABLE, dtype=np.int64)


_ADE_TABLE = [
    [0, 0, 0], [120, 120, 120], [180, 120, 120], [6, 230, 230], [80, 50, 50], [4, 200, 3],
    [120, 120, 80], [140, 140, 140], [204, 5, 255], [230, 230, 230], [4, 250, 7], [224, 5, 255],
    [235, 255, 7], [150, 5, 61], [120, 120, 70], [8, 255, 51], [255, 6, 82], [143, 255, 140],
    [204, 255, 4], [255, 51, 7], [204, 70, 3], [0, 102, 200], [61, 230, 250], [255, 6, 51],
    [11, 102, 255], [255, 7, 71], [255, 9, 224], [9, 7, 230], [220, 220, 220], [255, 9, 92],
    [112, 9, 255], [8, 255, 214], [7, 255, 224], [255, 184, 6], [10, 255, 71], [255, 41, 10],
    [7, 255, 255], [224, 255, 8], [102, 8, 255], [255, 61, 6], [255, 194, 7], [255, 122, 8],
    [0, 255, 20], [255, 8, 41], [255, 5, 153], [6, 51, 255], [235, 12, 255], [160, 150, 20],
    [0, 163, 255], [140, 140, 140], [250, 10, 15], [20, 255, 0], [31, 255, 0], [255, 31, 0],
    [255, 224, 0], [153, 255, 0], [0, 0, 255], [255, 71, 0], [0, 235, 255], [0, 173, 255],
    [31, 0, 255], [11, 200, 200], [255, 82, 0], [0, 255, 245], [0, 61, 255], [0, 255, 112],
    [0, 255, 133], [255, 0, 0], [255, 163, 0], [255, 102, 0], [194, 255, 0], [0, 143, 255],
    [51, 255, 0], [0, 82, 255], [0, 255, 41], [0, 255, 173], [10, 0, 255], [173, 255, 0],
    [0, 255, 153], [255, 92, 0], [255, 0, 255], [255, 0, 245], [255, 0, 102], [255, 173, 0],
    [255, 0, 20], [255, 184, 184], [0, 31, 255], [0, 255, 61], [0, 71, 255], [255, 0, 204],
    [0, 255, 194], [0, 255, 82], [0, 10, 255], [0, 112, 255], [51, 0, 255], [0, 194, 255],
    [0, 122, 255], [0, 255, 163], [255, 153, 0], [0, 255, 10], [255, 112, 0], [143, 255, 0],
    [82, 0, 255], [163, 255, 0], [255, 235, 0], [8, 184, 170], [133, 0, 255], [0, 255, 92],
    [184, 0, 255], [255, 0, 31], [0, 184, 255], [0, 214, 255], [255, 0, 112], [92, 255, 0],
    [0, 224, 255], [112, 224, 255], [70, 184, 160], [163, 0, 255], [153, 0, 255], [71, 255, 0],
    [255, 0, 163], [255, 204, 0], [255, 0, 143], [0, 255, 235], [133, 255, 0], [255, 0, 235],
    [245, 0, 255], [255, 0, 122], [255, 245, 0], [10, 190, 212], [214, 255, 0], [0, 204, 255],
    [20, 0, 255], [255, 255, 0], [0, 153, 255], [0, 41, 255], [0, 255, 204], [41, 0, 255],
    [41, 255, 0], [173, 0, 255], [0, 245, 255], [71, 0, 255], [122, 0, 255], [0, 255, 184],
    [0, 92, 255], [184, 255, 0], [0, 133, 255], [255, 214, 0], [25, 194, 194], [102, 255, 0],
    [92, 0, 255],
]


def render_instance_mask(
    anns: Sequence[Dict],
    image_size: int = 512,
    colormap: np.ndarray = None,
    min_area: float = 5000.0,
    use_native: bool = True,
) -> np.ndarray:
    """COCO-style annotations -> (image_size, image_size, 3) color mask.

    Exact reference semantics (reference: imagenetC.py:15-29): skip instances
    with area < 5000; color index = (cx_cell * cy_cell) % 124 where the
    centroid cell comes from an 11x11 grid; later instances overwrite earlier.

    Uses the fused C kernel (controlvar_tpu_torch/native) when it is
    available and the annotations are uniform compressed RLEs; else numpy.
    """
    if colormap is None:
        colormap = grid_color_map()
    if use_native and len(anns):
        from controlvar_tpu_torch import native

        if native.available():
            out = native.render_mask(anns, image_size, colormap, min_area)
            if out is not None:
                return out.astype(np.float64)
    mask = np.zeros((image_size, image_size, 3), dtype=np.float64)
    for ann in anns:
        if ann.get("area", np.inf) < min_area:
            continue
        m = decode_rle(ann["segmentation"])
        ys, xs = np.nonzero(m == 1)
        if len(xs) == 0:
            continue
        X, Y = m.shape[1], m.shape[0]
        x = int(np.mean(xs) // (X / 11))
        y = int(np.mean(ys) // (Y / 11))
        mask[m.astype(bool)] = colormap[(x * y) % len(colormap)]
    return mask
