"""Checkpoint download helper with md5 verification and local caching.

The port's own copy of `controlvar_tpu/ckpt/download.py` (standard
library only). Equivalent of the reference's get_ckpt_path (reference:
losses/util.py:5-44), covering the LPIPS VGG weights plus the released
model checkpoints named in its README (reference: README.md:19-24,125-132).
Uses urllib (no requests dependency); raises a clear error when the
environment has no network so offline callers can point --vae_ckpt/--ckpt
at pre-fetched files instead.
"""
from __future__ import annotations

import hashlib
import os
import urllib.request

URL_MAP = {
    # LPIPS VGG lin-head weights (reference: losses/util.py:5-7)
    "vgg_lpips": "https://heibox.uni-heidelberg.de/f/607503859c864bc1b30b/?dl=1",
    # released tokenizer (reference: README.md:19-24)
    "vae_ch160v4096z32": (
        "https://huggingface.co/FoundationVision/var/resolve/main/"
        "vae_ch160v4096z32.pth"
    ),
    # released ControlVAR joint checkpoints (reference: README.md:125-132)
    **{
        f"controlvar_d{d}": (
            f"https://huggingface.co/qiuk6/ControlVAR/resolve/main/d{d}.pth"
        )
        for d in (12, 16, 20, 24, 30)
    },
}

CKPT_MAP = {
    "vgg_lpips": "vgg.pth",
    "vae_ch160v4096z32": "vae_ch160v4096z32.pth",
    **{f"controlvar_d{d}": f"d{d}.pth" for d in (12, 16, 20, 24, 30)},
}

# md5 only published for the LPIPS weights (reference: losses/util.py:13-15);
# the HF releases carry no checksums - verified by size > 0 and torch load.
MD5_MAP = {
    "vgg_lpips": "d507d7349b931f0638a25a48a722f98a",
}


def md5_hash(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url: str, local_path: str, chunk_size: int = 1 << 20) -> None:
    os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
    tmp = local_path + ".part"
    try:
        with urllib.request.urlopen(url, timeout=60) as r, open(tmp, "wb") as f:
            while True:
                data = r.read(chunk_size)
                if not data:
                    break
                f.write(data)
    except OSError as e:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"could not download {url}: {e}. This environment may have no "
            f"network - fetch the file elsewhere and place it at "
            f"{local_path}."
        ) from e
    os.replace(tmp, local_path)


def get_ckpt_path(name: str, root: str, check: bool = False) -> str:
    """Return the local path of a named checkpoint, downloading on miss
    (reference: losses/util.py:36-44). `check` re-verifies the md5 of a
    cached file when a checksum is known."""
    if name not in URL_MAP:
        raise KeyError(f"unknown checkpoint {name!r}; known: {sorted(URL_MAP)}")
    path = os.path.join(root, CKPT_MAP[name])
    known_md5 = MD5_MAP.get(name)
    stale = (check and known_md5 is not None
             and os.path.exists(path) and md5_hash(path) != known_md5)
    if not os.path.exists(path) or stale:
        print(f"downloading {name} from {URL_MAP[name]} to {path}")
        download(URL_MAP[name], path)
        if known_md5 is not None:
            got = md5_hash(path)
            if got != known_md5:
                raise RuntimeError(
                    f"md5 mismatch for {name}: got {got}, want {known_md5}")
    return path
