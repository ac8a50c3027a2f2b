"""Weights and inputs of a plain VAR configuration with shared AdaLN, made
on the device from the run's seed, and the program's config objects for it
(`cvbench/weights.py` does the same for ControlVAR).

The tree has the keys and shapes of the port's `VARModel.init_params` with
`shared_aln` (`models/var.py`, `models/transformer.py:init_block_params`
and `init_head_params`): each block's `ada_gss` (6, C) in place of its
`ada_lin`, and the model's `shared_ada_lin` (C -> 6C). The gates are raised
in `shared_ada_lin`'s bias as the configuration's "init" says: that bias is
fp32 on the served path too (`prepare_params` casts the blocks, ada_gss
among them, to bf16, and a gate of 10 in bf16 would move by 1/16).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from cvbench.weights import device_generator

Params = Dict


def var_dims(m: Dict) -> Dict:
    """Derived sizes of a plain VAR configuration: one token stream, pn^2
    positions a scale."""
    pns = m["patch_nums"]
    C = m["embed_dim"]
    return dict(C=C, H=m["num_heads"], D=m["depth"], S=len(pns),
                L=sum(p * p for p in pns), first_l=pns[0] ** 2,
                hidden=round(C * m["mlp_ratio"]), V=m["vocab_size"], Cvae=m["cvae"])


def var_params(m: Dict, init: Dict, seed: int, device) -> Params:
    """The fp32 VAR tree with shared AdaLN (and cos_attn's scale_mul where
    the configuration has it) from `seed`."""
    d = var_dims(m)
    C, D, hidden = d["C"], d["D"], d["hidden"]
    g = device_generator(seed, "var", device)
    init_std = math.sqrt(1.0 / C / 3.0)

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=device) * std

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    gss = normal((D, 6, C), 1.0 / math.sqrt(C))
    gss[:, :2] *= m.get("aln_gamma_init", 1e-3)
    shared_bias = zeros(6 * C)
    gate_attn, gate_ffn = init["shared_gate_bias"]
    shared_bias[:C] += gate_attn
    shared_bias[C: 2 * C] += gate_ffn
    blocks = {
        "qkv_kernel": normal((D, C, 3 * C), 0.02),
        "q_bias": zeros(D, C),
        "v_bias": zeros(D, C),
        "proj": {"kernel": normal((D, C, C), 0.02 / math.sqrt(2 * D)), "bias": zeros(D, C)},
        "fc1": {"kernel": normal((D, C, hidden), 0.02), "bias": zeros(D, hidden)},
        "fc2": {"kernel": normal((D, hidden, C), 0.02 / math.sqrt(2 * D)), "bias": zeros(D, C)},
        "ada_gss": gss,
    }
    if m["cos_attn"]:
        blocks["scale_mul"] = torch.full((D, d["H"]), math.log(4.0), device=device)
    return {
        "word_embed": {"kernel": normal((d["Cvae"], C), 0.02), "bias": zeros(C)},
        "class_emb": normal((m["num_classes"] + 1, C), init_std),
        "pos_start": normal((1, d["first_l"], C), init_std),
        "pos_1LC": normal((1, d["L"], C), init_std),
        "lvl_embed": normal((d["S"], C), init_std),
        "blocks": blocks,
        "head_nm": {"ada_lin": {"kernel": normal((C, 2 * C), 0.02), "bias": zeros(2 * C)}},
        "head": {"kernel": normal((C, d["V"]), 0.02), "bias": zeros(d["V"])},
        "shared_ada_lin": {"kernel": normal((C, 6 * C), 0.02), "bias": shared_bias},
    }


def labels(n: int, num_classes: int, seed: int, tag: str, device) -> torch.Tensor:
    """n class ids uniform over the classes, from the seed."""
    g = device_generator(seed, tag, device)
    return torch.randint(0, num_classes, (n,), generator=g, device=device)


def model_configs(cfg: Dict):
    """The program's config objects (VARConfig, VQVAEConfig) for a plain VAR
    configuration file."""
    from controlvar_tpu_torch.config import VARConfig, VQVAEConfig

    m, v = cfg["model"], cfg["vqvae"]
    mc = VARConfig(
        depth=m["depth"], embed_dim=m["embed_dim"], num_heads=m["num_heads"],
        mlp_ratio=m["mlp_ratio"], num_classes=m["num_classes"], norm_eps=m["norm_eps"],
        cond_drop_rate=m["cond_drop_rate"], drop_path_rate=m["drop_path_rate"], tau=m["tau"],
        cos_attn=m["cos_attn"], shared_aln=m["shared_aln"],
        aln_gamma_init=m["aln_gamma_init"], patch_nums=tuple(m["patch_nums"]),
        vocab_size=m["vocab_size"], cvae=m["cvae"])
    vc = VQVAEConfig(vocab_size=v["vocab_size"], z_channels=v["z_channels"], ch=v["ch"],
                     ch_mult=tuple(v["ch_mult"]), num_res_blocks=v["num_res_blocks"],
                     quant_conv_ks=v["quant_conv_ks"], quant_resi=v["quant_resi"],
                     share_quant_resi=v["share_quant_resi"], patch_nums=tuple(v["patch_nums"]))
    return mc, vc
