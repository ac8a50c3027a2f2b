"""Export the port's param trees to reference-compatible .pth state dicts.

The port of `controlvar_tpu/ckpt/torch_export.py` and the inverse of
`ckpt/torch_import.py`: a model trained with the port loads into the
reference PyTorch stack (models/var.py, models/control_var.py,
models/vqvae.py), and convert(export(params)) == params bit for bit.

Conventions (mirroring the importer):
  OIHW conv kernel        -> torch Conv2d (O, I, kH, kW), unchanged
  (in, out) linear kernel -> torch Linear (out, in)
  scale/bias norm         -> weight/bias
Every entry is a contiguous fp32 CPU tensor with storage of its own. Only
parameters are exported; the reference's derived buffers (lvl_1L,
attn_bias_for_masking, zero_k_bias, ...) are rebuilt by its constructors.
"""
from __future__ import annotations

from typing import Dict

import torch

from controlvar_tpu_torch.config import ControlVARConfig, VARConfig, VQVAEConfig

StateDict = Dict[str, torch.Tensor]


def _t(a: torch.Tensor) -> torch.Tensor:
    return a.detach().to(device="cpu", dtype=torch.float32, copy=True,
                         memory_format=torch.contiguous_format)


def _conv(out: StateDict, name: str, p: Dict) -> None:
    out[f"{name}.weight"] = _t(p["kernel"])
    out[f"{name}.bias"] = _t(p["bias"])


def _norm(out: StateDict, name: str, p: Dict) -> None:
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])


def _linear(out: StateDict, name: str, p: Dict) -> None:
    out[f"{name}.weight"] = _t(p["kernel"].t())
    out[f"{name}.bias"] = _t(p["bias"])


def _resblock(out: StateDict, name: str, p: Dict) -> None:
    _norm(out, f"{name}.norm1", p["norm1"])
    _conv(out, f"{name}.conv1", p["conv1"])
    _norm(out, f"{name}.norm2", p["norm2"])
    _conv(out, f"{name}.conv2", p["conv2"])
    if "nin_shortcut" in p:
        _conv(out, f"{name}.nin_shortcut", p["nin_shortcut"])


def _attnblock(out: StateDict, name: str, p: Dict) -> None:
    _norm(out, f"{name}.norm", p["norm"])
    _conv(out, f"{name}.qkv", p["qkv"])
    _conv(out, f"{name}.proj_out", p["proj"])


def _coder(out: StateDict, prefix: str, p: Dict, updown: str) -> None:
    resample = "downsample" if updown == "down" else "upsample"
    _conv(out, f"{prefix}.conv_in", p["conv_in"])
    for i, lvl in enumerate(p[updown]):
        for j, blk in enumerate(lvl["block"]):
            _resblock(out, f"{prefix}.{updown}.{i}.block.{j}", blk)
        for j, att in enumerate(lvl["attn"]):
            _attnblock(out, f"{prefix}.{updown}.{i}.attn.{j}", att)
        if resample in lvl:
            _conv(out, f"{prefix}.{updown}.{i}.{resample}.conv", lvl[resample])
    _resblock(out, f"{prefix}.mid.block_1", p["mid"]["block_1"])
    _attnblock(out, f"{prefix}.mid.attn_1", p["mid"]["attn_1"])
    _resblock(out, f"{prefix}.mid.block_2", p["mid"]["block_2"])
    _norm(out, f"{prefix}.norm_out", p["norm_out"])
    _conv(out, f"{prefix}.conv_out", p["conv_out"])


def export_vqvae_state_dict(params: Dict, cfg: VQVAEConfig,
                            usage: Dict = None) -> StateDict:
    """The port's VQVAE params -> reference models/vqvae.py names. Phi convs
    take the default PhiPartiallyShared naming (quant_resi.qresi_ls.{i}, the
    released tokenizer's share_quant_resi=4 layout).
    `quantize.ema_vocab_hit_SV` is required by the reference's
    load_state_dict: from the usage EMA state (`usage["ema_hits"]`) when
    given, zeros otherwise."""
    out: StateDict = {}
    out["quantize.ema_vocab_hit_SV"] = (
        _t(torch.as_tensor(usage["ema_hits"])) if usage is not None
        else torch.zeros(len(cfg.patch_nums), cfg.vocab_size))
    _coder(out, "encoder", params["encoder"], "down")
    _coder(out, "decoder", params["decoder"], "up")
    _conv(out, "quant_conv", params["quant_conv"])
    _conv(out, "post_quant_conv", params["post_quant_conv"])
    out["quantize.embedding.weight"] = _t(params["quantize"]["embedding"])
    for i, phi in enumerate(params["quantize"]["phi"]):
        _conv(out, f"quantize.quant_resi.qresi_ls.{i}", phi)
    return out


def export_mask_vqvae_state_dict(params: Dict, cfg: VQVAEConfig, usage: Dict = None,
                                 mask_usage: Dict = None) -> StateDict:
    """The port's dual-codebook MaskVQVAE params -> reference
    models/vqvae_mask.py names: the single-codebook layout plus the mask
    codebook (`mask_quantize.*`, its usage EMA from `mask_usage` or zeros)
    and the shared `filter` conv."""
    out = export_vqvae_state_dict(params, cfg, usage=usage)
    _conv(out, "filter", params["filter"])
    mq = params["mask_quantize"]
    out["mask_quantize.embedding.weight"] = _t(mq["embedding"])
    for i, phi in enumerate(mq["phi"]):
        _conv(out, f"mask_quantize.quant_resi.qresi_ls.{i}", phi)
    out["mask_quantize.ema_vocab_hit_SV"] = (
        _t(torch.as_tensor(mask_usage["ema_hits"])) if mask_usage is not None
        else torch.zeros(len(cfg.patch_nums), cfg.vocab_size))
    return out


def export_var_state_dict(params: Dict, cfg: VARConfig) -> StateDict:
    """The port's VAR params -> reference models/var.py names (parameters
    only)."""
    out: StateDict = {}
    _linear(out, "word_embed", params["word_embed"])
    out["class_emb.weight"] = _t(params["class_emb"])
    out["pos_start"] = _t(params["pos_start"])
    out["pos_1LC"] = _t(params["pos_1LC"])
    out["lvl_embed.weight"] = _t(params["lvl_embed"])
    b = params["blocks"]
    for i in range(cfg.depth):
        out[f"blocks.{i}.attn.mat_qkv.weight"] = _t(b["qkv_kernel"][i].t())
        out[f"blocks.{i}.attn.q_bias"] = _t(b["q_bias"][i])
        out[f"blocks.{i}.attn.v_bias"] = _t(b["v_bias"][i])
        for name, ref in (("proj", "attn.proj"), ("fc1", "ffn.fc1"), ("fc2", "ffn.fc2")):
            out[f"blocks.{i}.{ref}.weight"] = _t(b[name]["kernel"][i].t())
            out[f"blocks.{i}.{ref}.bias"] = _t(b[name]["bias"][i])
        if cfg.shared_aln:
            out[f"blocks.{i}.ada_gss"] = _t(b["ada_gss"][i])
        else:
            out[f"blocks.{i}.ada_lin.1.weight"] = _t(b["ada_lin"]["kernel"][i].t())
            out[f"blocks.{i}.ada_lin.1.bias"] = _t(b["ada_lin"]["bias"][i])
        if cfg.cos_attn:
            out[f"blocks.{i}.attn.scale_mul_1H11"] = _t(b["scale_mul"][i].reshape(1, -1, 1, 1))
    _linear(out, "head_nm.ada_lin.1", params["head_nm"]["ada_lin"])
    _linear(out, "head", params["head"])
    if cfg.shared_aln:
        _linear(out, "shared_ada_lin.1", params["shared_ada_lin"])
    return out


def export_control_var_state_dict(params: Dict, cfg: ControlVARConfig) -> StateDict:
    """The port's ControlVAR params -> reference models/control_var.py names."""
    out = export_var_state_dict(params, cfg)
    for name in ("cond_embed", "type_embed", "special_embed"):
        if name in params:
            out[f"{name}.weight"] = _t(params[name])
    return out


def save_torch_checkpoint(path: str, state_dict: StateDict, step: int = 0,
                          epoch: int = 0) -> None:
    """Write a reference-trainer-shaped checkpoint {model_state_dict, epoch,
    step} (reference: train_control_var_hpu.py:420-428), fp32 on the CPU."""
    torch.save({"model_state_dict": {k: _t(torch.as_tensor(v)) for k, v in state_dict.items()},
                "epoch": epoch, "step": step}, path)
