"""Convert parameter trees between the JAX package and the port.

The input is a nested tree of dicts and lists of numpy arrays, as
`jax.tree_util.tree_map(np.asarray, params)` gives for a ControlVAR model or
a VQVAE of the JAX package. Dense kernels keep their (in, out) layout (the
port multiplies `x @ W` as JAX does); conv kernels go from HWIO to PyTorch's
OIHW. `to_jax_params` is the reverse for ControlVAR trees, for comparing
the port's parameters with the JAX package's. Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from controlvar_tpu_torch.config import ControlVARConfig, VQVAEConfig
from controlvar_tpu_torch.device import DeviceLike, resolve_device

_VQVAE_KEYS = {"encoder", "decoder", "quantize", "quant_conv", "post_quant_conv"}


def _convert(tree, conv: bool, device):
    if isinstance(tree, dict):
        return {k: (_convert(v, conv, device) if not (conv and k == "kernel")
                    else torch.from_numpy(np.ascontiguousarray(
                        np.asarray(v).transpose(3, 2, 0, 1))).to(device))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, conv, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)


def from_jax_params(tree, cfg, device: DeviceLike = None):
    """JAX-package params -> the port's params for `cfg` (a VQVAEConfig or a
    ControlVARConfig), on `device` (the GPU unless device="cpu")."""
    device = resolve_device(device)
    if isinstance(cfg, VQVAEConfig):
        if set(tree) != _VQVAE_KEYS:
            raise ValueError(f"not a VQVAE tree: keys {sorted(tree)}")
        # every "kernel" of the VQVAE is a 4-D HWIO conv kernel
        return _convert(tree, True, device)
    if isinstance(cfg, ControlVARConfig):
        if "blocks" not in tree or tree["blocks"]["qkv_kernel"].shape[0] != cfg.depth:
            raise ValueError("not a ControlVAR tree of this depth")
        return _convert(tree, False, device)
    raise TypeError(f"unsupported config {type(cfg).__name__}")



def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def to_jax_params(params, cfg):
    """The port's ControlVAR params -> a numpy tree in the JAX package's
    layout (the reverse of `from_jax_params`; dense kernels keep their
    layout)."""
    if not isinstance(cfg, ControlVARConfig):
        raise TypeError(f"unsupported config {type(cfg).__name__}")
    return _to_numpy(params)
