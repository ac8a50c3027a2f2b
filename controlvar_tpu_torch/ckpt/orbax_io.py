"""Checkpoints of the port's train state: save, resume and latest step.

The port of `controlvar_tpu/ckpt/orbax_io.py`, with the same class and
method names, on `torch.save`/`torch.load` in place of Orbax. A state is
a dataclass whose fields are tensor trees, `torch.optim` optimizers and
ints: the port's `TrainState` ({params, optimizer, step}) and the tokenizer
trainer's `GANTrainState` and `DualGANTrainState` (two param trees, two
Adam optimizers, the step and the codebook-usage trees). A checkpoint holds
every field (trees on the CPU, None nodes kept; optimizers as their
state_dict) and the caller's JSON metadata (the trainer's epoch, say).

One file a step, `<directory>/<step>.pt`. It is written under a temporary
name and renamed once whole, so `latest_step` never reports a step whose
write did not finish, as Orbax never reports an uncommitted one. Saves are
synchronous; `wait` is there for callers written against Orbax's
asynchronous saves.

Under tensor parallelism (a mesh whose model axis is above 1, and the
model's config) a checkpoint still holds the whole state, as the JAX
package's Orbax checkpoints hold global arrays: `save` gathers the params
and the AdamW moments over the model group (`parallel/tensor.py`; every
rank calls it, the primary process writes), and `restore` cuts the whole
trees to this rank's shard. A tensor-parallel run's checkpoint therefore
restores into a single-device run, and the reverse.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
from typing import Any, Dict, List, Optional

import torch

from controlvar_tpu_torch.device import tree_map
from controlvar_tpu_torch.parallel.distributed import is_primary
from controlvar_tpu_torch.parallel.mesh import tp_of
from controlvar_tpu_torch.parallel.tensor import (gather_opt_state, gather_params,
                                                  shard_opt_state, shard_params)
from controlvar_tpu_torch.train.param_groups import named_leaves

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _load_params(dst, src, field: str = "params") -> None:
    """Copy a saved tensor tree into `dst`'s tensors, on their devices."""
    want, got = dict(named_leaves(dst)), dict(named_leaves(src))
    if sorted(want) != sorted(got):
        raise ValueError(f"checkpoint {field} {sorted(got)} do not match the state's "
                         f"{sorted(want)}")
    with torch.no_grad():
        for name, leaf in want.items():
            if leaf.shape != got[name].shape:
                raise ValueError(f"checkpoint {field} {name}: shape "
                                 f"{tuple(got[name].shape)}, the state's {tuple(leaf.shape)}")
            leaf.copy_(got[name])


def _pack(value):
    if isinstance(value, torch.optim.Optimizer):
        return value.state_dict()
    if isinstance(value, (int, float)):
        return value
    return tree_map(lambda t: t.detach().cpu(), value)


class CheckpointIO:
    """Train-state checkpoints in one directory, keeping the newest
    `max_to_keep` steps. mesh and cfg: a tensor-parallel mesh and the
    config of the model whose shard the states hold (module docstring)."""

    def __init__(self, directory: str, max_to_keep: int = 3, mesh=None, cfg=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.tp, self.cfg = tp_of(mesh), cfg
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.pt")

    def _steps(self) -> List[int]:
        """The steps whose checkpoint was written whole, ascending."""
        found = (_STEP_FILE.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def _pack_whole(self, value, state):
        """A field of a shard's state made whole over the model group, then
        packed."""
        if isinstance(value, torch.optim.Optimizer):
            return gather_opt_state(self.tp, value.state_dict(), state.params, self.cfg)
        if isinstance(value, (int, float)):
            return value
        return _pack(gather_params(self.tp, value, self.cfg))

    def save(self, step: int, state: Any, metadata: Optional[Dict] = None) -> None:
        """Write `state` (every field of its dataclass) as `step`, then drop
        the oldest steps beyond max_to_keep. metadata must be
        JSON-serialisable. Under tensor parallelism every rank calls it and
        the primary process writes the whole state."""
        pack = _pack if self.tp is None else functools.partial(self._pack_whole, state=state)
        payload = {f.name: pack(getattr(state, f.name)) for f in dataclasses.fields(state)}
        if self.tp is not None and not is_primary():
            return
        payload["metadata"] = None if metadata is None else json.dumps(metadata)
        path = self._path(step)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self._steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def _load(self, step: Optional[int]):
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        ck = torch.load(self._path(step), map_location="cpu", weights_only=True)
        meta = None if ck["metadata"] is None else json.loads(ck["metadata"])
        return ck, meta

    def restore(self, state_like: Any, step: Optional[int] = None):
        """Load `step` (the latest when None) into `state_like`, field by
        field: its tensor trees in place, on their devices; its optimizers
        by load_state_dict (which moves each moment to its param's device);
        its step count; under tensor parallelism each whole tree cut to this
        rank's shard first. Returns (state_like, metadata), or (None, None)
        when there is no checkpoint."""
        ck, meta = self._load(step)
        if ck is None:
            return None, None
        tp = self.tp
        for f in dataclasses.fields(state_like):
            value, saved = getattr(state_like, f.name), ck[f.name]
            if isinstance(value, torch.optim.Optimizer):
                if tp is not None:
                    saved = shard_opt_state(tp, saved, state_like.params, self.cfg)
                value.load_state_dict(saved)
            elif isinstance(value, (int, float)):
                setattr(state_like, f.name, saved)
            else:
                if tp is not None:
                    saved = shard_params(tp, saved, tp.model_index, self.cfg)
                _load_params(value, saved, f.name)
        return state_like, meta

    def restore_raw(self, step: Optional[int] = None):
        """Template-free restore: ({field: value} of the saved state, as
        numpy arrays and Python values, metadata), for export and inspection
        tools that do not build a state."""
        ck, meta = self._load(step)
        if ck is None:
            return None, None
        raw = {k: v for k, v in ck.items() if k != "metadata"}
        return tree_map(lambda v: v.numpy() if isinstance(v, torch.Tensor) else v, raw), meta

    def wait(self) -> None:
        """Nothing to wait for: `save` returns once the file is renamed."""
