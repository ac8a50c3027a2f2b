"""Device policy of the port's entry points."""
from __future__ import annotations

import contextlib
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    None means the GPU: it raises when CUDA is not available rather than
    carrying on on the CPU. Pass device="cpu" to run on the CPU, where every
    kernel wrapper takes its plain PyTorch version.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "controlvar_tpu_torch runs on CUDA by default and no GPU is "
                "available; pass device='cpu' to run the plain CPU path")
        return torch.device("cuda")
    return torch.device(device)


def generator_for(seed: int) -> torch.Generator:
    """A seeded CPU generator: the port's source of randomness on both
    devices (on the GPU it only seeds the in-kernel Philox)."""
    g = torch.Generator()
    g.manual_seed(int(seed))
    return g


def tree_to(tree, device: torch.device, dtype=None):
    """Move every tensor of a nested dict/list parameter tree to `device`
    (and, for floating tensors, to `dtype` when given)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device, dtype) for v in tree]
    if dtype is not None and tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device)


@contextlib.contextmanager
def no_tf32():
    """Full-fp32 matmuls and convolutions inside the block (the counterpart
    of the JAX package's `Precision.HIGHEST`): TF32 keeps ~3 decimal digits,
    enough to flip a codebook argmin."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
