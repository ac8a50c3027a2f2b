"""COCO run-length-encoded mask codec in plain numpy (the port's copy of
`controlvar_tpu/data/rle.py`).

The COCO compressed-RLE format: column-major alternating zero/one runs,
counts LEB128-style packed into printable chars with 5-bit payloads and
delta-coded from the third count on. Host-side data-pipeline code.
"""
from __future__ import annotations

from typing import Dict, List, Union

import numpy as np


def _counts_from_string(s: Union[str, bytes]) -> List[int]:
    if isinstance(s, str):
        s = s.encode("ascii")
    cnts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def _counts_to_string(cnts: List[int]) -> str:
    out = bytearray()
    for i, x in enumerate(cnts):
        if i > 2:
            x = x - cnts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            out.append(c + 48)
    return out.decode("ascii")


def decode_rle(rle: Dict) -> np.ndarray:
    """{'size': [h, w], 'counts': str|bytes|list} -> (h, w) uint8 mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _counts_from_string(counts)
    counts = np.asarray(counts, dtype=np.int64)
    vals = np.zeros(len(counts), dtype=np.uint8)
    vals[1::2] = 1  # runs alternate 0, 1, 0, 1, ...
    flat = np.repeat(vals, counts)
    if flat.size != h * w:
        flat = np.resize(flat, h * w)
    return flat.reshape((w, h)).T  # column-major


def encode_rle(mask: np.ndarray) -> Dict:
    """(h, w) binary mask -> compressed RLE dict (round-trip/testing)."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).T.reshape(-1)  # column-major
    # run lengths
    change = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(bounds).tolist()
    if flat[0] == 1:  # counts must start with a zero-run
        runs = [0] + runs
    return {"size": [h, w], "counts": _counts_to_string([int(r) for r in runs])}
