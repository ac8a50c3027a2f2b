"""Dataset factory, threaded host loader, and the copy of a batch to the
card (the port's copy of `controlvar_tpu/data/build.py`, plus `to_device`).

The loader replaces the reference's torch DataLoader + DistributedSampler
(reference: datasets/build.py:27-65, train_control_var_hpu.py:564-574):
worker threads decode and transform samples (PIL and numpy release the GIL
for the heavy parts) and batches are dicts of stacked NHWC numpy arrays, as
in the JAX package, so that the two loaders compare bit for bit.
`to_device` copies such a batch to the card through pinned memory. Sharding
across processes is index-based (`shard_id`/`num_shards`).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch


def create_dataset(name: str, **kwargs):
    """Factory mirroring the reference's name dispatch (datasets/build.py)."""
    name = name.lower()
    if name in ("imagenetc", "imagenet_c"):
        from controlvar_tpu_torch.data.imagenetc import ImagenetCDataset

        return ImagenetCDataset(**kwargs)
    if name == "synthetic":
        from controlvar_tpu_torch.data.imagenetc import SyntheticControlDataset

        return SyntheticControlDataset(**kwargs)
    if name in ("imagenetm", "imagenet_m"):
        from controlvar_tpu_torch.data.datasets_extra import ImagenetMDataset

        return ImagenetMDataset(**kwargs)
    if name in ("imagenets", "imagenet_s"):
        from controlvar_tpu_torch.data.datasets_extra import ImagenetSDataset

        return ImagenetSDataset(**kwargs)
    if name == "sa1b":
        from controlvar_tpu_torch.data.datasets_extra import SA1BDataset

        return SA1BDataset(**kwargs)
    if name in ("imagenet", "imagefolder"):
        # plain class-labelled tree, no control stream (plain-VAR baseline;
        # reference: train_var_hpu.py ImageFolder path)
        from controlvar_tpu_torch.data.datasets_extra import ImageFolderDataset

        return ImageFolderDataset(**kwargs)
    if name in ("coco", "entitys", "entity_seg"):
        # EntitySeg uses the same COCO-annotation format
        # (reference: datasets/entityS.py:39-111)
        from controlvar_tpu_torch.data.datasets_extra import CocoMaskDataset

        return CocoMaskDataset(**kwargs)
    raise NotImplementedError(
        f"dataset '{name}' (supported: imagenetC, imagenetM, imagenetS, sa1b, "
        "coco/entityS, imagenet, synthetic)"
    )


class Loader:
    """Epoch-shuffled, sharded, prefetching batch iterator."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
        num_workers: int = 8,
        prefetch: int = 4,
        drop_last: bool = True,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.ds)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        # even per-shard split (mirrors DistributedSampler padding semantics)
        per = -(-n // self.num_shards)
        pad = np.resize(idx, per * self.num_shards)
        return pad[self.shard_id::self.num_shards]

    def steps_per_epoch(self) -> int:
        # shard length without materializing the permutation (1.28M indices
        # at ImageNet scale): padded even split = ceil(n / num_shards)
        n = -(-len(self.ds) // self.num_shards)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int,
              skip_batches: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Iterate the epoch's batches; `skip_batches` drops the first N
        WITHOUT building them (mid-epoch resume: the per-epoch shuffle is
        seed-deterministic, so skipping reproduces the exact continuation —
        the reference only stubbed this, train_control_var_hpu.py:138-143)."""
        indices = self._epoch_indices(epoch)
        nb = self.steps_per_epoch()
        skip = min(max(0, skip_batches), nb)
        work: "queue.Queue" = queue.Queue()
        done_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)

        for b in range(skip, nb):
            work.put((b, indices[b * self.batch_size:(b + 1) * self.batch_size]))
        nb -= skip

        emit_cv = threading.Condition()
        next_emit = [skip]  # first live batch index after a mid-epoch skip
        abort = threading.Event()

        def worker(wid: int):
            while not abort.is_set():
                try:
                    b, idxs = work.get_nowait()
                except queue.Empty:
                    return
                # A raising ds.sample must not kill the thread silently: the
                # consumer would block forever on done_q.get() and peers would
                # deadlock waiting for slot b. Emit the exception in-order as a
                # poison pill instead; the consumer re-raises it.
                try:
                    # per-SAMPLE rng keyed by (seed, epoch, index): sample
                    # augmentations are reproducible regardless of worker
                    # count, dynamic work scheduling, or a mid-epoch resume
                    # (a per-worker sequential stream would make batch
                    # content depend on which worker built it)
                    samples = [
                        self.ds.sample(
                            int(i),
                            np.random.default_rng((self.seed, epoch, int(i))),
                        )
                        for i in idxs
                    ]
                    batch = {
                        k: np.stack([s[k] for s in samples]) for k in samples[0]
                    }
                except BaseException as exc:  # noqa: BLE001 — re-raised by consumer
                    batch = _WorkerError(exc)
                # in-order emission: wait for our slot, then put OUTSIDE the
                # cv (a blocking put while holding it would strand every peer
                # once the consumer stops draining). Exclusive ownership of
                # slot b is guaranteed because next_emit only advances below.
                with emit_cv:
                    emit_cv.wait_for(lambda: abort.is_set()
                                     or next_emit[0] == b)
                    if abort.is_set():
                        return
                while not abort.is_set():
                    try:
                        done_q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                with emit_cv:
                    next_emit[0] += 1
                    emit_cv.notify_all()

        threads = [
            threading.Thread(target=worker, args=(w,), daemon=True)
            for w in range(self.num_workers)
        ]
        for t in threads:
            t.start()

        def _release_workers():
            # stop pending work, wake slot-waiters, and drain done_q so
            # blocked put()s observe the abort
            abort.set()
            with emit_cv:
                emit_cv.notify_all()
            for q in (work, done_q):
                while True:
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
            for t in threads:
                t.join(timeout=5.0)

        try:
            for _ in range(nb):
                item = done_q.get()
                if isinstance(item, _WorkerError):
                    _release_workers()
                    raise RuntimeError(
                        "data loader worker failed while building a batch"
                    ) from item.exc
                yield item
            for t in threads:
                t.join()
        except GeneratorExit:
            # consumer broke out of the epoch (step cap, preemption): free
            # the worker threads instead of leaking them blocked on the
            # emission queue until process exit
            _release_workers()
            raise


class _WorkerError:
    """In-order poison pill carrying a worker exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def to_device(batch, device):
    """A batch (a dict of numpy arrays or tensors, lists of them too) as
    tensors on `device`. Host arrays bound for the card go through pinned
    memory and are copied without blocking the host."""
    device = torch.device(device)

    def move(x):
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [move(v) for v in x]
        t = torch.from_numpy(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        if device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return move(batch)
