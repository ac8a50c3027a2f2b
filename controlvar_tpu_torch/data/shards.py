"""Sharded dataset IO: tar-shard reading and offline pre-tokenization (the
port's copy of `controlvar_tpu/data/shards.py`; its shards and the JAX
package's are the same files).

Two pieces:
  * TarShardReader: a webdataset-style sequential reader over .tar shards
    of (image, control, metadata) triples (PIL, imported when iterating);
  * token shards: `pretokenize` writes one .npz of int16 per-scale token ids
    per batch, so that training skips the two VQVAE encoder passes a step
    (`ControlVARTrainStep(from_tokens=True)` through `TokenShardLoader`).
"""
from __future__ import annotations

import dataclasses
import glob
import io
import json
import os
import tarfile
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class TarShardReader:
    """Iterates samples from `{prefix}-{idx}.tar` shards.

    Each sample is a basename with member files:
      <key>.image.jpg/png   <key>.control.jpg/png   <key>.json (cls, type)
    """

    pattern: str  # glob, e.g. /data/shards/train-*.tar
    image_size: int = 256
    random_crop: bool = True

    def __post_init__(self):
        from controlvar_tpu_torch.data.transforms import PairedTransform

        self.shards = sorted(glob.glob(self.pattern))
        self.transform = PairedTransform(self.image_size, random_crop=self.random_crop)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        from PIL import Image

        rng = np.random.default_rng(0)
        for shard in self.shards:
            with tarfile.open(shard) as tf:
                groups: Dict[str, Dict[str, bytes]] = {}
                for m in tf.getmembers():
                    if not m.isfile():
                        continue
                    base, _, rest = m.name.partition(".")
                    groups.setdefault(base, {})[rest] = tf.extractfile(m).read()
                for key in sorted(groups):
                    g = groups[key]
                    img_bytes = next((g[k] for k in g if k.startswith("image")), None)
                    ctl_bytes = next((g[k] for k in g if k.startswith("control")), None)
                    meta = json.loads(g.get("json", b"{}"))
                    if img_bytes is None:
                        continue
                    image = Image.open(io.BytesIO(img_bytes)).convert("RGB")
                    control = (
                        Image.open(io.BytesIO(ctl_bytes)).convert("RGB")
                        if ctl_bytes is not None else image
                    )
                    img, ctl = self.transform(image, control.resize(image.size), rng=rng)
                    yield {
                        "image": img,
                        "mask": ctl,
                        "cls": np.int32(meta.get("cls", 0)),
                        "type": np.int32(meta.get("type", 0)),
                    }


# ----------------------------------------------------------------------------
# offline tokenization
# ----------------------------------------------------------------------------

def write_token_shard(path: str, ctrl_ids: Sequence[np.ndarray],
                      img_ids: Sequence[np.ndarray], cls: np.ndarray,
                      cond_type: np.ndarray,
                      ignore_mask: Optional[np.ndarray] = None) -> None:
    """One shard = one batch of per-scale token ids, stored as int16 (V =
    4096 fits): an id outside [0, 32768) raises instead of wrapping."""
    for t in list(ctrl_ids) + list(img_ids):
        t = np.asarray(t)
        if t.size and (t.min() < 0 or t.max() >= 32768):
            raise ValueError(f"token ids must lie in [0, 32768) to be stored as int16, "
                             f"got [{t.min()}, {t.max()}]")
    arrays = {
        f"ctrl_{i}": np.asarray(t, np.int16) for i, t in enumerate(ctrl_ids)
    }
    arrays.update({f"img_{i}": np.asarray(t, np.int16) for i, t in enumerate(img_ids)})
    arrays["cls"] = np.asarray(cls, np.int32)
    arrays["type"] = np.asarray(cond_type, np.int32)
    if ignore_mask is not None:
        arrays["ignore_mask"] = np.packbits(
            np.asarray(ignore_mask, np.float32) > 0.5, axis=-1
        )
        arrays["ignore_len"] = np.asarray([ignore_mask.shape[-1]], np.int32)
    np.savez_compressed(path, **arrays)


def read_token_shard(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        num_scales = sum(1 for k in z.files if k.startswith("ctrl_"))
        out = {
            "ctrl_ids": [z[f"ctrl_{i}"].astype(np.int32) for i in range(num_scales)],
            "img_ids": [z[f"img_{i}"].astype(np.int32) for i in range(num_scales)],
            "cls": z["cls"],
            "type": z["type"],
        }
        if "ignore_mask" in z.files:
            L = int(z["ignore_len"][0])
            out["ignore_mask"] = np.unpackbits(
                z["ignore_mask"], axis=-1
            )[..., :L].astype(np.float32)
        return out


def pretokenize(vqvae, vq_params, loader, out_dir: str, epochs: Sequence[int] = (0,),
                compute_dtype=torch.bfloat16) -> int:
    """Tokenize a pixel Loader into token shards, one per batch, on the
    VQVAE's device (bf16 encoder by default, as in the JAX package).
    Returns the shard count."""
    from controlvar_tpu_torch.data.build import to_device

    os.makedirs(out_dir, exist_ok=True)

    @torch.no_grad()
    def tok(x):
        ids = vqvae.img_to_ids(vq_params, to_device(x, vqvae.device),
                               compute_dtype=compute_dtype)
        return [t.cpu().numpy() for t in ids]

    n = 0
    for epoch in epochs:
        for batch in loader.epoch(epoch):
            ctrl, img = tok(batch["mask"]), tok(batch["image"])
            write_token_shard(
                os.path.join(out_dir, f"tokens_{epoch:03d}_{n:06d}.npz"),
                ctrl, img, batch["cls"], batch["type"],
                batch.get("ignore_mask"),
            )
            n += 1
    return n


@dataclasses.dataclass
class TokenShardDataset:
    """Streams pre-tokenized batches (`ControlVARTrainStep` with from_tokens)."""

    pattern: str  # glob over token_*.npz

    def __post_init__(self):
        self.paths = sorted(glob.glob(self.pattern))

    def __len__(self):
        return len(self.paths)

    def __iter__(self):
        for p in self.paths:
            yield read_token_shard(p)


@dataclasses.dataclass
class TokenShardLoader:
    """Trainer-compatible loader over pre-tokenized batch shards.

    Mirrors `data.build.Loader`'s interface (`steps_per_epoch()` /
    `epoch(epoch, skip_batches=)`), so that a trainer feeds its token
    batches to `ControlVARTrainStep.step(from_tokens=True)`: one shard file
    = one training batch, shuffled per epoch with a seed-deterministic
    permutation and split evenly across processes (padded even split, the
    pixel Loader's DistributedSampler semantics; reference:
    train_control_var_hpu.py:569-574)."""

    pattern: str  # glob over tokens_*.npz written by `pretokenize`
    shuffle: bool = True
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1

    def __post_init__(self):
        self.paths = sorted(glob.glob(self.pattern))
        if not self.paths:
            raise FileNotFoundError(f"no token shards match {self.pattern!r}")

    def steps_per_epoch(self) -> int:
        return -(-len(self.paths) // self.num_shards)

    def epoch(self, epoch: int, skip_batches: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        idx = np.arange(len(self.paths))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        pad = np.resize(idx, self.steps_per_epoch() * self.num_shards)
        mine = pad[self.shard_id::self.num_shards]
        for b in mine[max(0, skip_batches):]:
            yield read_token_shard(self.paths[int(b)])
