"""Multi-process parallelism on `torch.distributed`.

The port of `controlvar_tpu/parallel/distributed.py`. One process per
device: `initialize()` joins the process group from the same environment
variables as the JAX package (COORDINATOR_ADDRESS, NUM_PROCESSES,
PROCESS_ID). Under data parallelism each rank's loader reads its own shard
and the train steps average every gradient over the ranks with
`average_gradients` before the clip; under tensor parallelism
(`parallel/mesh.py`, `parallel/tensor.py`) the loader shard is the rank's
data index and the average runs over its data group only. The port's steps
take parameter trees, not `nn.Module`s, so
`torch.nn.parallel.DistributedDataParallel` does not apply. Every helper
here is a no-op (or the single-process answer) when no group is
initialized.
"""
from __future__ import annotations

import datetime
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from controlvar_tpu_torch.data.build import to_device
from controlvar_tpu_torch.device import DeviceLike, resolve_device
from controlvar_tpu_torch.utils.tracker import span


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group. No-op for a single process (no address and
    no process count given or in the environment).

    The backend is `backend`, else the DIST_BACKEND environment variable,
    else NCCL for the GPU (the default device) and gloo for device="cpu".
    Ranks that share one card need gloo: NCCL refuses two ranks on one
    device, and gloo takes CUDA tensors for the all_reduce and broadcast
    that the port's collectives are made of. The coordinator address is
    host:port (or tcp://host:port) of rank 0; on a GPU machine each rank
    takes the device of its local rank, `process_id %
    torch.cuda.device_count()`.
    """
    coord = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    nproc = num_processes if num_processes is not None else (
        int(os.environ["NUM_PROCESSES"]) if "NUM_PROCESSES" in os.environ else None
    )
    # `is not None`, not truthiness: process_id=0 is the coordinator itself
    pid = process_id if process_id is not None else (
        int(os.environ["PROCESS_ID"]) if "PROCESS_ID" in os.environ else None
    )
    if coord is None and nproc is None:
        return  # single process
    if coord is None or nproc is None or pid is None:
        raise ValueError("initialize needs the coordinator address, the number of "
                         "processes and this process's id")
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(pid % torch.cuda.device_count())
    backend = backend or os.environ.get("DIST_BACKEND") or (
        "nccl" if device.type == "cuda" else "gloo")
    init = coord if "://" in coord else f"tcp://{coord}"
    dist.init_process_group(backend, init_method=init,
                            world_size=nproc, rank=pid,
                            timeout=datetime.timedelta(minutes=10))


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if _initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def local_device_count() -> int:
    """GPUs this process can see; a CPU-only process has one device."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def form_global_batch(device, batch: dict) -> dict:
    """This rank's rows of the global batch, on `device`. Each rank feeds its
    disjoint loader shard; the global batch is the union of the ranks'
    rows, held together by the gradient average (the counterpart of the JAX
    package's globally sharded array; reference: DistributedSampler +
    per-rank DataLoader, train_control_var_hpu.py:569-574)."""
    return to_device(batch, device)


def group_size(group=None) -> int:
    """The number of ranks of `group` (None: the whole world); 1 without a
    process group."""
    return dist.get_world_size(group) if _initialized() else 1


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `t` over the ranks of `group` (None: every rank; a new
    tensor; `t` itself without a process group)."""
    if not _initialized():
        return t
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out


def average_gradients(params: Iterable[torch.Tensor], group=None) -> None:
    """Replace every `.grad` of `params` by its mean over the ranks of
    `group` (None: every rank; under tensor parallelism the data group), in
    place, through one all-reduce of their concatenation (so every rank ends
    with the same bits). A no-op without a process group and over a
    subgroup of one rank; over the whole world, even of one rank, the
    all-reduce runs."""
    if not _initialized() or (group is not None and dist.get_world_size(group) == 1):
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    with span("allreduce"):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat.div_(dist.get_world_size(group))
        offset = 0
        for g in grads:
            g.copy_(flat[offset: offset + g.numel()].view_as(g))
            offset += g.numel()


def barrier() -> None:
    if _initialized():
        dist.barrier()
