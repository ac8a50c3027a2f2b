"""Seeding and metric smoothing (reference: utils/misc.py:20,30-185)."""
from __future__ import annotations

import collections
import datetime
import random
import time
from typing import Dict

import numpy as np
import torch


def seed_everything(seed: int, deterministic: bool = True) -> None:
    """Seed Python's, numpy's and torch's global generators (reference:
    utils/misc.py:20). The port's own randomness goes through explicit
    generators (`device.generator_for`); this covers third-party code that
    draws from the global ones."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


class SmoothedValue:
    """Windowed + global average tracker (reference: utils/misc.py:30-80)."""

    def __init__(self, window_size: int = 30, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=max(self.deque) if self.deque else 0.0,
            value=self.deque[-1] if self.deque else 0.0,
        )


class MetricLogger:
    """Iteration logger with ETA (reference: utils/misc.py:82-185)."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = ""):
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        n = len(iterable) if hasattr(iterable, "__len__") else None
        end = time.time()
        for obj in iterable:
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                if n:
                    eta = datetime.timedelta(seconds=int(iter_time.global_avg * (n - i)))
                    print(f"{header} [{i}/{n}] eta: {eta} {self} time: {iter_time}",
                          flush=True)
                else:
                    print(f"{header} [{i}] {self} time: {iter_time}", flush=True)
            i += 1
            end = time.time()
        total = time.time() - start
        print(f"{header} done in {datetime.timedelta(seconds=int(total))}", flush=True)
