"""Convert parameter trees between the JAX package and the port.

The input is a nested tree of dicts and lists of numpy arrays, as
`jax.tree_util.tree_map(np.asarray, params)` gives for a ControlVAR model, a
plain VAR model, a VQVAE or MaskVQVAE, the PatchGAN discriminator or LPIPS
of the JAX package (None nodes, the discriminator's layers without
BatchNorm, stay None). Dense kernels keep their (in,
out) layout (the port multiplies `x @ W` as JAX does); conv kernels go from
HWIO to PyTorch's OIHW. `to_jax_params` is the reverse for ControlVAR and
VAR trees, for comparing the port's parameters with the JAX package's.
Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from controlvar_tpu_torch.config import ControlVARConfig, VARConfig, VQVAEConfig
from controlvar_tpu_torch.device import DeviceLike, resolve_device

_VQVAE_KEYS = {"encoder", "decoder", "quantize", "quant_conv", "post_quant_conv"}
_MASK_VQVAE_KEYS = _VQVAE_KEYS | {"mask_quantize", "filter"}
# the loss networks' trees, told apart by their keys: every "kernel" a conv
_LOSS_KEYS = ({"layers"}, {"stages", "lins"})
# parameters only a ControlVAR tree has (multi_cond, type_pos, separator)
_CONTROL_ONLY_KEYS = {"cond_embed", "type_embed", "special_embed"}


def _convert(tree, conv: bool, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: (_convert(v, conv, device) if not (conv and k == "kernel")
                    else torch.from_numpy(np.ascontiguousarray(
                        np.asarray(v).transpose(3, 2, 0, 1))).to(device))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, conv, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)


def _transformer_kind(cfg) -> str:
    """'ControlVAR' or 'VAR' (ControlVARConfig subclasses VARConfig, so it
    is tested first), else a TypeError."""
    if isinstance(cfg, ControlVARConfig):
        return "ControlVAR"
    if isinstance(cfg, VARConfig):
        return "VAR"
    raise TypeError(f"unsupported config {type(cfg).__name__}")


def from_jax_params(tree, cfg, device: DeviceLike = None):
    """JAX-package params -> the port's params for `cfg` (a VQVAEConfig for a
    VQVAE or MaskVQVAE tree, a ControlVARConfig or a VARConfig; None for the
    discriminator's tree, {"layers"}, or LPIPS's, {"stages", "lins"}), on
    `device` (the GPU unless device="cpu")."""
    device = resolve_device(device)
    if cfg is None:
        if set(tree) not in _LOSS_KEYS:
            raise ValueError(f"not a discriminator or LPIPS tree: keys {sorted(tree)}")
        return _convert(tree, True, device)
    if isinstance(cfg, VQVAEConfig):
        if set(tree) not in (_VQVAE_KEYS, _MASK_VQVAE_KEYS):
            raise ValueError(f"not a VQVAE tree: keys {sorted(tree)}")
        # every "kernel" of the VQVAE is a 4-D HWIO conv kernel
        return _convert(tree, True, device)
    kind = _transformer_kind(cfg)
    if ("blocks" not in tree or tree["blocks"]["qkv_kernel"].shape[0] != cfg.depth
            or np.shape(tree.get("pos_1LC", ()))[1:2] != (cfg.seq_len,)
            or (kind == "VAR" and _CONTROL_ONLY_KEYS & set(tree))):
        raise ValueError(f"not a {kind} tree of this depth and sequence length")
    return _convert(tree, False, device)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def to_jax_params(params, cfg):
    """The port's ControlVAR or VAR params -> a numpy tree in the JAX
    package's layout (the reverse of `from_jax_params`; dense kernels keep
    their layout)."""
    _transformer_kind(cfg)
    return _to_numpy(params)
