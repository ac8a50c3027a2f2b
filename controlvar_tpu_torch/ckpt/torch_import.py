"""Import reference PyTorch checkpoints (.pth) into the port's param trees.

The port of `controlvar_tpu/ckpt/torch_import.py`. It covers the VAR
tokenizer `vae_ch160v4096z32.pth`, plain VAR `var_d{N}.pth` and ControlVAR
`d{N}.pth` joint checkpoints, and produces the trees `from_jax_params`
gives for the JAX package's conversions of the same state dicts.

Conventions:
  torch Conv2d weight (O, I, kH, kW)  -> kept: the port's convs are OIHW
  torch Linear weight (out, in)       -> (in, out): the port computes x @ W + b
  torch norm weight/bias              -> scale/bias
Per-layer block weights are stacked on a leading depth axis. Every leaf is
an fp32 tensor on the requested device.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from controlvar_tpu_torch.config import ControlVARConfig, VARConfig, VQVAEConfig
from controlvar_tpu_torch.device import DeviceLike, resolve_device

StateDict = Mapping[str, object]   # name -> torch.Tensor or numpy array


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Deserialize a .pth into {name: CPU tensor}, unwrapping a trainer
    checkpoint (`model_state_dict`) or a `state_dict` entry and stripping
    the DDP `module.` prefix. The reference checkpoints pickle more than
    tensors, so this loads with weights_only=False: load only files of a
    source you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model_state_dict" in obj:  # trainer checkpoint
        obj = obj["model_state_dict"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    out = {}
    for k, v in obj.items():
        k = k.removeprefix("module.")  # DDP prefix
        out[k] = v.detach().cpu() if isinstance(v, torch.Tensor) else _as_tensor(np.asarray(v))
    return out


def _as_tensor(a) -> torch.Tensor:
    """A tensor entry as it is; a numpy entry as a tensor over its memory
    (over a copy when it is read-only, as arrays from JAX are)."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.require(a, requirements="W"))


class _Reader:
    """Reads state-dict entries as contiguous fp32 tensors on one device."""

    def __init__(self, sd: StateDict, device: torch.device):
        self.sd, self.device = sd, device

    def __contains__(self, name: str) -> bool:
        return name in self.sd

    def __call__(self, name: str) -> torch.Tensor:
        return self.tensor(_as_tensor(self.sd[name]))

    def tensor(self, t: torch.Tensor) -> torch.Tensor:
        # a copy: the params never share memory with the state dict
        return t.to(device=self.device, dtype=torch.float32, copy=True,
                    memory_format=torch.contiguous_format)

    def conv(self, name: str) -> Dict:
        return {"kernel": self(f"{name}.weight"), "bias": self(f"{name}.bias")}

    def norm(self, name: str) -> Dict:
        return {"scale": self(f"{name}.weight"), "bias": self(f"{name}.bias")}

    def linear(self, name: str) -> Dict:
        w = _as_tensor(self.sd[f"{name}.weight"])
        return {"kernel": self.tensor(w.t()), "bias": self(f"{name}.bias")}

    def stack(self, fmt: str, depth: int, transpose: bool = False) -> torch.Tensor:
        ts = [_as_tensor(self.sd[fmt.format(i)]) for i in range(depth)]
        return self.tensor(torch.stack([t.t() if transpose else t for t in ts]))


def _resblock(r: _Reader, name: str) -> Dict:
    p = {"norm1": r.norm(f"{name}.norm1"), "conv1": r.conv(f"{name}.conv1"),
         "norm2": r.norm(f"{name}.norm2"), "conv2": r.conv(f"{name}.conv2")}
    if f"{name}.nin_shortcut.weight" in r:
        p["nin_shortcut"] = r.conv(f"{name}.nin_shortcut")
    return p


def _attnblock(r: _Reader, name: str) -> Dict:
    return {"norm": r.norm(f"{name}.norm"), "qkv": r.conv(f"{name}.qkv"),
            "proj": r.conv(f"{name}.proj_out")}


def _mid(r: _Reader, prefix: str) -> Dict:
    return {"block_1": _resblock(r, f"{prefix}.mid.block_1"),
            "attn_1": _attnblock(r, f"{prefix}.mid.attn_1"),
            "block_2": _resblock(r, f"{prefix}.mid.block_2")}


def _levels(r: _Reader, prefix: str, updown: str, n_lvl: int, n_blocks: int) -> list:
    """The encoder's `down` or the decoder's `up` levels: resblocks, the
    attention blocks present, and the resampling conv where there is one."""
    resample = "downsample" if updown == "down" else "upsample"
    levels = []
    for i in range(n_lvl):
        base = f"{prefix}.{updown}.{i}"
        attns, j = [], 0
        while f"{base}.attn.{j}.norm.weight" in r:
            attns.append(_attnblock(r, f"{base}.attn.{j}"))
            j += 1
        lvl = {"block": [_resblock(r, f"{base}.block.{j}") for j in range(n_blocks)],
               "attn": attns}
        if f"{base}.{resample}.conv.weight" in r:
            lvl[resample] = r.conv(f"{base}.{resample}.conv")
        levels.append(lvl)
    return levels


def _encoder(r: _Reader, cfg: VQVAEConfig, prefix: str = "encoder") -> Dict:
    return {"conv_in": r.conv(f"{prefix}.conv_in"),
            "down": _levels(r, prefix, "down", len(cfg.ch_mult), cfg.num_res_blocks),
            "mid": _mid(r, prefix),
            "norm_out": r.norm(f"{prefix}.norm_out"),
            "conv_out": r.conv(f"{prefix}.conv_out")}


def _decoder(r: _Reader, cfg: VQVAEConfig, prefix: str = "decoder") -> Dict:
    return {"conv_in": r.conv(f"{prefix}.conv_in"),
            "mid": _mid(r, prefix),
            "up": _levels(r, prefix, "up", len(cfg.ch_mult), cfg.num_res_blocks + 1),
            "norm_out": r.norm(f"{prefix}.norm_out"),
            "conv_out": r.conv(f"{prefix}.conv_out")}


def convert_vqvae_state_dict(sd: StateDict, cfg: VQVAEConfig,
                             device: DeviceLike = None) -> Dict:
    """The reference VQVAE state dict (models/vqvae.py names) -> the port's
    VQVAE params, on `device` (the GPU unless device="cpu")."""
    r = _Reader(sd, resolve_device(device))
    phi, i = [], 0
    while f"quantize.quant_resi.qresi_ls.{i}.weight" in r:
        phi.append(r.conv(f"quantize.quant_resi.qresi_ls.{i}"))
        i += 1
    if not phi:  # non-shared variant stores phis directly on the ModuleList
        while f"quantize.quant_resi.{i}.weight" in r:
            phi.append(r.conv(f"quantize.quant_resi.{i}"))
            i += 1
    return {"encoder": _encoder(r, cfg), "decoder": _decoder(r, cfg),
            "quant_conv": r.conv("quant_conv"), "post_quant_conv": r.conv("post_quant_conv"),
            "quantize": {"embedding": r("quantize.embedding.weight"), "phi": phi}}


def _blocks(r: _Reader, cfg: VARConfig) -> Dict:
    """Per-layer block weights stacked on a leading depth axis."""
    d = cfg.depth
    p = {
        # fused qkv: torch (3C, C) -> (C, 3C)
        "qkv_kernel": r.stack("blocks.{}.attn.mat_qkv.weight", d, transpose=True),
        "q_bias": r.stack("blocks.{}.attn.q_bias", d),
        "v_bias": r.stack("blocks.{}.attn.v_bias", d),
    }
    for name, ref in (("proj", "attn.proj"), ("fc1", "ffn.fc1"), ("fc2", "ffn.fc2")):
        p[name] = {"kernel": r.stack(f"blocks.{{}}.{ref}.weight", d, transpose=True),
                   "bias": r.stack(f"blocks.{{}}.{ref}.bias", d)}
    if cfg.shared_aln:
        p["ada_gss"] = r.stack("blocks.{}.ada_gss", d)
    else:
        p["ada_lin"] = {"kernel": r.stack("blocks.{}.ada_lin.1.weight", d, transpose=True),
                        "bias": r.stack("blocks.{}.ada_lin.1.bias", d)}
    if cfg.cos_attn:
        p["scale_mul"] = r.stack("blocks.{}.attn.scale_mul_1H11", d).reshape(d, -1)
    return p


def _var_params(r: _Reader, cfg: VARConfig) -> Dict:
    p = {
        "word_embed": r.linear("word_embed"),
        "class_emb": r("class_emb.weight"),
        "pos_start": r("pos_start"),
        "pos_1LC": r("pos_1LC"),
        "lvl_embed": r("lvl_embed.weight"),
        "blocks": _blocks(r, cfg),
        "head_nm": {"ada_lin": r.linear("head_nm.ada_lin.1")},
        "head": r.linear("head"),
    }
    if cfg.shared_aln:
        p["shared_ada_lin"] = r.linear("shared_ada_lin.1")
    return p


def convert_var_state_dict(sd: StateDict, cfg: VARConfig, device: DeviceLike = None) -> Dict:
    """A plain VAR checkpoint (models/var.py names) -> the port's VAR params,
    on `device` (the GPU unless device="cpu")."""
    return _var_params(_Reader(sd, resolve_device(device)), cfg)


def convert_control_var_state_dict(sd: StateDict, cfg: ControlVARConfig,
                                   device: DeviceLike = None) -> Dict:
    """A ControlVAR checkpoint (models/control_var.py names) -> the port's
    ControlVAR params, on `device` (the GPU unless device="cpu")."""
    r = _Reader(sd, resolve_device(device))
    p = _var_params(r, cfg)
    for flag, name in ((cfg.multi_cond, "cond_embed"), (cfg.type_pos, "type_embed"),
                       (cfg.separator, "special_embed")):
        if flag and f"{name}.weight" in r:
            p[name] = r(f"{name}.weight")
    return p
