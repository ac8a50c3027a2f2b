"""Parity tooling: compare the port's token streams and logits against the
PyTorch reference on the same weights.

The port of `controlvar_tpu/eval/parity.py`: the same two functions, with
the same arguments and reports, and one argument more, `device`, where the
port's side runs (the GPU unless device="cpu"; without a GPU and without a
device they raise). The port's side runs in fp32 with TF32 off
(`device.no_tf32`): cuDNN's convolutions round to TF32 by default, which
flips codebook argmins. The teacher-forced logits take the JAX package's
`use_flash=False` path, attention as plain einsums (`ops.attention.mha_xla`)
and no kernel.

The north-star acceptance test (BASELINE.md): tokenize a fixed image with
the released `vae_ch160v4096z32.pth` through both stacks and demand
identical id streams; teacher-forced ControlVAR logits from `d{N}.pth` must
match to float tolerance. The reference's modules (`models.vqvae` and
`models.control_var` of the upstream ControlVAR checkout) run on the CPU,
imported read-only from REFERENCE_ROOT inside the functions only and never
copied. REFERENCE_ROOT is the checkout that the CONTROLVAR_REFERENCE_ROOT
environment variable names.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, Sequence

import numpy as np

REFERENCE_ROOT = os.environ.get("CONTROLVAR_REFERENCE_ROOT", "")


def _import_reference():
    if not REFERENCE_ROOT:
        raise RuntimeError("parity needs the upstream ControlVAR checkout: set "
                           "CONTROLVAR_REFERENCE_ROOT to its directory")
    if REFERENCE_ROOT not in sys.path:
        sys.path.insert(0, REFERENCE_ROOT)


def token_stream_parity(
    vae_ckpt_path: str,
    images_nhwc: np.ndarray,
    patch_nums: Sequence[int] = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16),
    device=None,
) -> Dict:
    """Tokenize images (B, H, W, 3) in [-1, 1] through both stacks; returns
    per-scale match rates."""
    import torch

    from controlvar_tpu_torch.ckpt.torch_import import (convert_vqvae_state_dict,
                                                        load_torch_state_dict)
    from controlvar_tpu_torch.config import VQVAEConfig
    from controlvar_tpu_torch.device import no_tf32, resolve_device
    from controlvar_tpu_torch.models.vqvae import VQVAE

    device = resolve_device(device)
    _import_reference()
    from models.vqvae import VQVAE as RefVQVAE  # type: ignore

    cfg = VQVAEConfig(patch_nums=tuple(patch_nums))
    sd = load_torch_state_dict(vae_ckpt_path)
    ours = VQVAE(cfg, device=device)
    params = convert_vqvae_state_dict(sd, cfg, device=device)

    ref = RefVQVAE(vocab_size=cfg.vocab_size, z_channels=cfg.z_channels,
                   ch=cfg.ch, v_patch_nums=cfg.patch_nums, test_mode=True)
    ref.load_state_dict({k: v.clone() for k, v in sd.items()}, strict=False)

    x = torch.from_numpy(images_nhwc)
    with torch.no_grad():
        ids_ref = ref.img_to_idxBl(x.permute(0, 3, 1, 2).contiguous(),
                                   v_patch_nums=cfg.patch_nums)
    with torch.no_grad(), no_tf32():
        ids_ours = ours.img_to_ids(params, x.to(device))

    per_scale = []
    total = match = 0
    for r, o in zip(ids_ref, ids_ours):
        m = int((r.cpu() == o.cpu()).sum())
        n = r.numel()
        per_scale.append(m / n)
        match += m
        total += n
    return {
        "per_scale_match": per_scale,
        "total_match_rate": match / total,
        "bitwise": match == total,
    }


def logits_parity(
    model_ckpt_path: str,
    depth: int,
    labels: np.ndarray,
    cond_type: np.ndarray,
    x_tf: np.ndarray,
    atol: float = 5e-3,
    device=None,
) -> Dict:
    """Teacher-forced ControlVAR logits through both stacks (fp32)."""
    import torch

    from controlvar_tpu_torch.ckpt.torch_import import (convert_control_var_state_dict,
                                                        load_torch_state_dict)
    from controlvar_tpu_torch.config import control_var_config_from_depth
    from controlvar_tpu_torch.device import no_tf32, resolve_device
    from controlvar_tpu_torch.models.control_var import ControlVARModel

    device = resolve_device(device)
    _import_reference()
    from models.control_var import ControlVAR as RefControlVAR  # type: ignore
    from models.vqvae import VQVAE as RefVQVAE  # type: ignore

    cfg = control_var_config_from_depth(depth, multi_cond=True, cond_drop_rate=0.0)
    sd = load_torch_state_dict(model_ckpt_path)
    ours = ControlVARModel(cfg, device=device)
    params = convert_control_var_state_dict(sd, cfg, device=device)

    ref_vae = RefVQVAE(vocab_size=cfg.vocab_size, z_channels=cfg.cvae,
                       ch=160, v_patch_nums=cfg.patch_nums, test_mode=True)
    ref = RefControlVAR(
        vae_local=ref_vae, depth=depth, embed_dim=cfg.embed_dim,
        num_heads=cfg.num_heads, patch_nums=cfg.patch_nums,
        mask_factor=cfg.mask_factor, multi_cond=True, cond_drop_rate=0.0,
        flash_if_available=False, fused_if_available=False,
    ).eval()
    ref.load_state_dict({k: v.clone() for k, v in sd.items()}, strict=False)

    with torch.no_grad():
        ref_logits = ref(
            torch.from_numpy(labels), torch.from_numpy(x_tf),
            cond_type=torch.from_numpy(cond_type), mask_first=True,
        ).cpu().numpy()
    with torch.no_grad(), no_tf32():
        our_logits = ours.forward_train(
            params, torch.from_numpy(labels.astype(np.int64)).to(device),
            torch.from_numpy(x_tf).to(device),
            cond_type=torch.from_numpy(cond_type.astype(np.int64)).to(device),
            train=False, compute_dtype=torch.float32, use_flash=False,
        ).cpu().numpy()
    diff = np.abs(our_logits - ref_logits)
    return {
        "max_abs_diff": float(diff.max()),
        "mean_abs_diff": float(diff.mean()),
        "within_tolerance": bool(diff.max() <= atol),
        "argmax_match_rate": float(
            (our_logits.argmax(-1) == ref_logits.argmax(-1)).mean()
        ),
    }
