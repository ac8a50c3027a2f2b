"""Experiment tracking: wandb when it imports, JSONL otherwise (the
reference hard-depends on wandb, reference: utils/wandb.py:7-26), a
`torch.profiler` trace of a window of train steps, and the spans that mark
the layers of a call or step inside any profiler window.

wandb is imported inside `Tracker.__init__` and PNGs are written with the
standard library's zlib: the GPU machine has neither wandb nor PIL.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import struct
import time
import zlib
from typing import Dict, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


def write_png(path: str, rgb: np.ndarray) -> None:
    """An (H, W, 3) uint8 array as an 8-bit RGB PNG: one IDAT chunk of
    zlib-compressed scanlines, each with filter type 0."""
    h, w, c = rgb.shape
    if c != 3 or rgb.dtype != np.uint8:
        raise ValueError(f"write_png takes (H, W, 3) uint8, not {rgb.shape} {rgb.dtype}")

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


class Tracker:
    def __init__(self, project: str, name: Optional[str] = None,
                 config: Optional[Dict] = None, out_dir: str = "."):
        self._wandb = None
        try:
            import wandb  # type: ignore

            self._wandb = wandb
            wandb.init(project=project, name=name, config=config or {})
        except Exception:
            self._wandb = None
            os.makedirs(out_dir, exist_ok=True)
            self._file = open(
                os.path.join(out_dir, f"metrics_{name or project}.jsonl"), "a"
            )

    def log(self, metrics: Dict, step: Optional[int] = None) -> None:
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
            return
        rec = {"t": time.time(), **({"step": step} if step is not None else {}),
               **{k: float(v) if hasattr(v, "__float__") else v for k, v in metrics.items()}}
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def log_images(self, tag: str, images, step: Optional[int] = None,
                   out_dir: str = "./media") -> None:
        """Images (N, H, W, 3) float [0,1] (numpy or CPU tensors): wandb or
        PNG files `<tag>_<step>_<i>.png`."""
        if self._wandb is not None:
            self._wandb.log({tag: [self._wandb.Image(np.asarray(i)) for i in images]},
                            step=step)
            return
        os.makedirs(out_dir, exist_ok=True)
        for i, img in enumerate(images):
            arr = (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)
            write_png(os.path.join(out_dir, f"{tag}_{step or 0}_{i}.png"), arr)

    def finish(self):
        if self._wandb is not None:
            self._wandb.finish()
        elif hasattr(self, "_file"):
            self._file.close()


class StepProfiler:
    """torch.profiler over steps [start_step, start_step + num_steps): the
    host and, where there is one, the GPU; the Chrome trace is written to
    `log_dir/trace_steps_<start>_<end>.json` when the window ends."""

    def __init__(self, log_dir: str, start_step: int = 10, num_steps: int = 3):
        self.log_dir = log_dir
        self.start_step = start_step
        self.end_step = start_step + num_steps
        self._prof = None

    def step(self, step: int) -> None:
        if step == self.start_step and self._prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
        elif step == self.end_step and self._prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.stop()
            os.makedirs(self.log_dir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(
                self.log_dir, f"trace_steps_{self.start_step}_{self.end_step}.json"))
            self._prof = None


# ---- spans -------------------------------------------------------------------
#
# The layers of a call (`eval/harness.py`, `eval/stepwise.py`) and of a train
# step (`train/train_step.py`) open spans named "cv/<name>": cv/call or
# cv/step holds the rest of one call or step, and cv/wait marks each point
# where the host blocks on the device. While a torch.profiler window is open
# (`StepProfiler`, the benchmark's `--trace 1`) a span is a record_function
# range, on the profiler's clock beside the device's operations, kept in the
# profiler's memory and written out by whoever owns the window; otherwise it
# is one shared null context, and costs a flag read.

SPAN_PREFIX = "cv/"
_NULL_SPAN = contextlib.nullcontext()

if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def profiler_enabled() -> bool:
        """Whether a torch.profiler window is open."""
        return _autograd_profiler._is_profiler_enabled
else:
    profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A range "cv/<name>" while the profiler is on, else a null context."""
    if not profiler_enabled():
        return _NULL_SPAN
    if _gc_span not in gc.callbacks:
        gc.callbacks.append(_gc_span)
    return torch.profiler.record_function(SPAN_PREFIX + name)


class _GCSpan:
    """The `gc.callbacks` hook that wraps each collection made while the
    profiler is on in a cv/gc range (collections never overlap)."""

    _open = None

    def __call__(self, phase: str, info: Dict) -> None:
        if phase == "start":
            if profiler_enabled():
                self._open = torch.profiler.record_function(SPAN_PREFIX + "gc")
                self._open.__enter__()
        elif self._open is not None:
            rf, self._open = self._open, None
            rf.__exit__(None, None, None)


_gc_span = _GCSpan()
