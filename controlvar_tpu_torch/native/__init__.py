"""ctypes binding of the native data-path kernels (`rle_native.c`): COCO RLE
decode and the fused instance-mask render.

The library is compiled with the system C compiler at first use, into
`build/native/` at the repository root (never beside the source), cached by
a hash of the source; a missing compiler makes `available()` false and the
callers take their numpy paths.

  available() -> bool
  rle_decode(counts: str, h, w) -> (h, w) uint8
  render_mask(anns, image_size, colormap, min_area) -> (H, W, 3) uint8, or
      None when the annotations are not all string RLEs at that size
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Dict, Optional, Sequence

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rle_native.c")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "native")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _target() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"librle_native_{digest}.so")


def _build() -> Optional[str]:
    """The cached library, compiled first if need be (into a temporary
    file renamed into place, so that a concurrent process never loads half a
    file); None when no C compiler succeeds."""
    target = _target()
    if os.path.exists(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    for cc in ("cc", "gcc", "clang"):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([cc, "-O3", "-shared", "-fPIC", _SRC, "-o", tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, target)
            return target
        except (OSError, subprocess.SubprocessError):
            continue
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.rle_decode.restype = ctypes.c_int
        lib.rle_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ]
        lib.render_mask.restype = ctypes.c_int
        lib.render_mask.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_double,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ]
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def rle_decode(counts: str, h: int, w: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native RLE library is unavailable (no C compiler)")
    out = np.zeros((h, w), np.uint8)
    rc = lib.rle_decode(counts.encode("ascii"), h, w, out)
    if rc != 0:
        raise ValueError(f"rle_decode failed rc={rc}")
    return out


def render_mask(anns: Sequence[Dict], image_size: int, colormap: np.ndarray,
                min_area: float = 5000.0) -> Optional[np.ndarray]:
    """The fused native path of `data.colormap.render_instance_mask`. Needs
    every annotation's RLE at (image_size, image_size) with string counts;
    returns None otherwise, for the caller's numpy path."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native RLE library is unavailable (no C compiler)")
    for ann in anns:
        seg = ann.get("segmentation", {})
        if not (isinstance(seg.get("counts"), str)
                and tuple(seg.get("size", ())) == (image_size, image_size)):
            return None
    counts = (ctypes.c_char_p * len(anns))(
        *[a["segmentation"]["counts"].encode("ascii") for a in anns])
    areas = np.asarray([float(a.get("area", np.inf)) for a in anns], np.float64)
    cmap = np.ascontiguousarray(colormap.astype(np.uint8))
    out = np.zeros((image_size, image_size, 3), np.uint8)
    rc = lib.render_mask(counts, areas, len(anns), image_size, image_size,
                         cmap, len(cmap), float(min_area), out)
    if rc != 0:
        raise ValueError(f"render_mask failed rc={rc}")
    return out
