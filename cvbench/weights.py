"""Weights and inputs made on the device from the run's seed, and the
program's config objects for a configuration file.

The trees have the keys and shapes that the port's `init_params` gives
(`models/control_var.py`, `models/transformer.py:init_block_params` and
`init_head_params`, `models/vqvae.py`, `models/vae.py`, `models/
quantizer.py`) and the distributions of that init, drawn by one generator
on the device in one call per leaf instead of leaf by leaf on the host.
Constant leaves take their constants. The AdaLN gate biases are raised as
`configs/<name>.json` "init" says: at the init's 1e-3 the gates leave
attention out of every output, and a trained model's are open.

The same seed gives the same trees; the reference regenerates them after
the window instead of keeping a copy.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch

Params = Dict


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (`tag`) of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def device_generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def model_dims(m: Dict) -> Dict:
    """Derived sizes of a ControlVAR model configuration (configs/*.json
    "model"): C, H, hd, D, L, first_l, S, hidden."""
    pns = m["patch_nums"]
    C, H = m["embed_dim"], m["num_heads"]
    return dict(C=C, H=H, hd=C // H, D=m["depth"], S=len(pns),
                L=sum(2 * p * p for p in pns), first_l=2 * pns[0] ** 2,
                hidden=round(C * m["mlp_ratio"]), V=m["vocab_size"], Cvae=m["cvae"])


def controlvar_params(m: Dict, init: Dict, seed: int, device) -> Params:
    """The fp32 ControlVAR tree (multi_cond, without the separator,
    type_pos or shared_aln options) from `seed`."""
    d = model_dims(m)
    C, D, hidden = d["C"], d["D"], d["hidden"]
    g = device_generator(seed, "controlvar", device)
    init_std = math.sqrt(1.0 / C / 3.0)

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=device) * std

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    ada = normal((D, C, 6 * C), 0.02)
    ada[:, :, : 2 * C] *= m.get("aln_gamma_init", 1e-3)
    ada_bias = zeros(D, 6 * C)
    gate_attn, gate_ffn = init["ada_gate_bias"]
    ada_bias[:, :C] += gate_attn
    ada_bias[:, C: 2 * C] += gate_ffn
    blocks = {
        "qkv_kernel": normal((D, C, 3 * C), 0.02),
        "q_bias": zeros(D, C),
        "v_bias": zeros(D, C),
        "proj": {"kernel": normal((D, C, C), 0.02 / math.sqrt(2 * D)), "bias": zeros(D, C)},
        "fc1": {"kernel": normal((D, C, hidden), 0.02), "bias": zeros(D, hidden)},
        "fc2": {"kernel": normal((D, hidden, C), 0.02 / math.sqrt(2 * D)), "bias": zeros(D, C)},
        "ada_lin": {"kernel": ada, "bias": ada_bias},
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
        "cond_embed": normal((m["num_cond_types"], C), init_std),
    }


def vqvae_params(v: Dict, seed: int, device) -> Params:
    """The fp32 VQVAE tree (encoder, decoder, quant convs, codebook and phi
    convs) from `seed`: convs U(+-1/sqrt(fan_in)) as torch's default, norms
    at (1, 0), the codebook N(0, 1)."""
    g = device_generator(seed, "vqvae", device)

    def conv(k, cin, cout):
        bound = 1.0 / math.sqrt(k * k * cin)
        w = torch.rand((cout, cin, k, k), generator=g, device=device) * (2 * bound) - bound
        b = torch.rand((cout,), generator=g, device=device) * (2 * bound) - bound
        return {"kernel": w, "bias": b}

    def norm(c):
        return {"scale": torch.ones(c, device=device), "bias": torch.zeros(c, device=device)}

    def resblock(cin, cout):
        p = {"norm1": norm(cin), "conv1": conv(3, cin, cout), "norm2": norm(cout),
             "conv2": conv(3, cout, cout)}
        if cin != cout:
            p["nin_shortcut"] = conv(1, cin, cout)
        return p

    def attn(c):
        return {"norm": norm(c), "qkv": conv(1, c, 3 * c), "proj": conv(1, c, c)}

    ch, mult, nrb, z = v["ch"], v["ch_mult"], v["num_res_blocks"], v["z_channels"]
    n = len(mult)
    down, block_in = [], ch
    for i in range(n):
        block_in, block_out = ch * ((1,) + tuple(mult))[i], ch * mult[i]
        blocks, attns = [], []
        for _ in range(nrb):
            blocks.append(resblock(block_in, block_out))
            block_in = block_out
            if i == n - 1:
                attns.append(attn(block_in))
        lvl = {"block": blocks, "attn": attns}
        if i != n - 1:
            lvl["downsample"] = conv(3, block_in, block_in)
        down.append(lvl)
    encoder = {"conv_in": conv(3, 3, ch), "down": down,
               "mid": {"block_1": resblock(block_in, block_in), "attn_1": attn(block_in),
                       "block_2": resblock(block_in, block_in)},
               "norm_out": norm(block_in), "conv_out": conv(3, block_in, z)}
    block_in = ch * mult[-1]
    decoder = {"conv_in": conv(3, z, block_in),
               "mid": {"block_1": resblock(block_in, block_in), "attn_1": attn(block_in),
                       "block_2": resblock(block_in, block_in)}}
    up = [None] * n
    for i in reversed(range(n)):
        block_out = ch * mult[i]
        blocks, attns = [], []
        for _ in range(nrb + 1):
            blocks.append(resblock(block_in, block_out))
            block_in = block_out
            if i == n - 1:
                attns.append(attn(block_in))
        lvl = {"block": blocks, "attn": attns}
        if i != 0:
            lvl["upsample"] = conv(3, block_in, block_in)
        up[i] = lvl
    decoder.update(up=up, norm_out=norm(block_in), conv_out=conv(3, block_in, 3))
    n_phi = v["share_quant_resi"]
    quantize = {"embedding": torch.randn((v["vocab_size"], z), generator=g, device=device),
                "phi": [conv(3, z, z) for _ in range(n_phi)]}
    return {"encoder": encoder, "decoder": decoder, "quantize": quantize,
            "quant_conv": conv(v["quant_conv_ks"], z, z),
            "post_quant_conv": conv(v["quant_conv_ks"], z, z)}


def named_leaves(tree, prefix: str = ""):
    """("a/b/c", tensor) for every leaf of a nested dict/list tree, in order."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            yield from named_leaves(v, name)
        else:
            yield name, v


def pixel_images(n: int, size: int, seed: int, tag: str, device) -> torch.Tensor:
    """n (size, size, 3) images in [-1, 1], NHWC, uniform from the seed."""
    g = device_generator(seed, tag, device)
    return torch.rand((n, size, size, 3), generator=g, device=device) * 2 - 1


def labels_types(n: int, num_classes: int, num_types: int, seed: int, tag: str,
                 device) -> Tuple[torch.Tensor, torch.Tensor]:
    """n class ids uniform over the classes and n cond types uniform over the
    control types, from the seed."""
    g = device_generator(seed, tag, device)
    cls = torch.randint(0, num_classes, (n,), generator=g, device=device)
    typ = torch.randint(0, num_types, (n,), generator=g, device=device)
    return cls, typ


def model_configs(cfg: Dict):
    """The program's config objects for a configuration file."""
    from controlvar_tpu_torch.config import ControlVARConfig, VQVAEConfig

    m, v = cfg["model"], cfg["vqvae"]
    mc = ControlVARConfig(
        depth=m["depth"], embed_dim=m["embed_dim"], num_heads=m["num_heads"],
        mlp_ratio=m["mlp_ratio"], num_classes=m["num_classes"], norm_eps=m["norm_eps"],
        cond_drop_rate=m["cond_drop_rate"], drop_path_rate=m["drop_path_rate"], tau=m["tau"],
        cos_attn=m["cos_attn"], aln_gamma_init=m["aln_gamma_init"],
        patch_nums=tuple(m["patch_nums"]), vocab_size=m["vocab_size"], cvae=m["cvae"],
        mask_factor=2, multi_cond=True, num_cond_types=m["num_cond_types"])
    vc = VQVAEConfig(vocab_size=v["vocab_size"], z_channels=v["z_channels"], ch=v["ch"],
                     ch_mult=tuple(v["ch_mult"]), num_res_blocks=v["num_res_blocks"],
                     quant_conv_ks=v["quant_conv_ks"], quant_resi=v["quant_resi"],
                     share_quant_resi=v["share_quant_resi"], patch_nums=tuple(v["patch_nums"]))
    return mc, vc
