"""Serving-oriented dispatch: `pipelined_map`.

The port of `controlvar_tpu/eval/serving.py`. A naive generate→save loop
serializes host post-processing (PNG encoding, metrics) with device work.
`pipelined_map` keeps up to `depth` batches dispatched and not yet
yielded: while the consumer post-processes batch i, the work already
queued for batches i+1..i+depth-1 can run on the device.

Eager PyTorch returns from `fn(item)` once the host has queued the
batch's kernels, which for a sampler means after the host has issued all
of its launches; only the device's tail of a batch overlaps the
consumer's work on the batch before it. Each in-flight batch keeps its
own device buffers until it is yielded, so `depth` bounds peak device
memory.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator, Tuple, TypeVar

import torch

T = TypeVar("T")
R = TypeVar("R")


def _tensors(tree):
    """The tensors of a nest of tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _done_event(result):
    """An event recorded on the current CUDA stream when the result holds a
    CUDA tensor or a pinned host tensor (the target of a copy from the card
    that may still be queued); None for plain CPU results."""
    if not any(t.is_cuda or t.is_pinned() for t in _tensors(result)):
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream())
    return event


def pipelined_map(
    fn: Callable[[T], R],
    items: Iterable[T],
    depth: int = 2,
) -> Iterator[Tuple[T, R]]:
    """Lazily map `fn` over `items` with up to `depth` calls in flight;
    yields (item, result) in submission order.

    `fn` returns tensors (any nest of tuples, lists and dicts of them). An
    event recorded after each call is waited on before its result is
    yielded, so a yielded result is complete (a pinned host copy of a
    canvas too) while the batches dispatched after it keep running; plain
    CPU results are yielded without a wait. `items` is consumed lazily: at
    most `depth` items are dispatched and not yet yielded at once."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    q: deque = deque()

    def pop():
        item, out, event = q.popleft()
        if event is not None:
            event.synchronize()
        return item, out

    for item in items:
        if len(q) >= depth:
            yield pop()
        out = fn(item)
        q.append((item, out, _done_event(out)))
    while q:
        yield pop()
