"""Static model and sampling configuration of the PyTorch port.

The port's own copy of the dataclasses of `controlvar_tpu/config.py`: the
depth-to-shape law, the ControlVAR interleaved-sequence bookkeeping and the
default sampling recipe. Field names and defaults are the same, so a config
built here describes the same model as its JAX counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

PATCH_NUMS_DEFAULT: Tuple[int, ...] = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)

COND_TYPES = ("mask", "canny", "depth", "normal")

# cond-type ids of multi-cond ControlVAR: 0-3 are mask/canny/depth/normal,
# 4 is the "dropped" (unconditional) entry
COND_UNCOND_ID = 4


@dataclasses.dataclass(frozen=True)
class VQVAEConfig:
    """Multi-scale residual-VQ tokenizer."""

    vocab_size: int = 4096
    z_channels: int = 32
    ch: int = 160
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    dropout: float = 0.0
    beta: float = 0.25
    using_znorm: bool = False
    quant_conv_ks: int = 3
    quant_resi: float = 0.5       # phi(x) = 0.5*conv(x) + 0.5*x
    share_quant_resi: int = 4     # partially-shared phi
    patch_nums: Tuple[int, ...] = PATCH_NUMS_DEFAULT

    @property
    def num_scales(self) -> int:
        return len(self.patch_nums)

    @property
    def downsample(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)


@dataclasses.dataclass(frozen=True)
class VARConfig:
    """Class-conditional next-scale AR transformer."""

    depth: int = 16
    embed_dim: int = 1024
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    norm_eps: float = 1e-6
    cond_drop_rate: float = 0.1
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    tau: float = 4.0
    cos_attn: bool = False
    shared_aln: bool = False
    aln_init: float = 1.0
    aln_gamma_init: float = 1e-3
    patch_nums: Tuple[int, ...] = PATCH_NUMS_DEFAULT
    vocab_size: int = 4096
    cvae: int = 32

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def seq_len(self) -> int:
        return sum(pn * pn for pn in self.patch_nums)

    @property
    def first_l(self) -> int:
        return self.patch_nums[0] ** 2

    @property
    def num_scales(self) -> int:
        return len(self.patch_nums)

    @property
    def attn_scale(self) -> float:
        return 1.0 / (self.head_dim ** 0.5) / self.tau

    def scale_seg_len(self, si: int) -> int:
        """Token count of scale si (pn^2; the port's addition, so that the
        samplers index VAR and ControlVAR sequences alike)."""
        return self.patch_nums[si] ** 2

    @property
    def begin_ends(self) -> Tuple[Tuple[int, int], ...]:
        out, cur = [], 0
        for si in range(len(self.patch_nums)):
            seg = self.scale_seg_len(si)
            out.append((cur, cur + seg))
            cur += seg
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class ControlVARConfig(VARConfig):
    """Joint control+image interleaved VAR: each scale holds `mask_factor`
    segments, (control_k, image_k) for mask_factor=2."""

    mask_factor: int = 2
    bidirectional: bool = False
    separate_decoding: bool = False
    separator: bool = False
    type_pos: bool = False
    indep: bool = False
    multi_cond: bool = False
    num_cond_types: int = 5       # mask/canny/depth/normal/uncond

    @property
    def seq_len(self) -> int:
        L = sum(pn * pn * self.mask_factor for pn in self.patch_nums)
        if self.separator:
            L += (len(self.patch_nums) - 1) * self.mask_factor
        return L

    @property
    def first_l(self) -> int:
        return self.patch_nums[0] ** 2 * self.mask_factor

    @property
    def num_sep_tokens(self) -> int:
        return (len(self.patch_nums) - 1) * self.mask_factor if self.separator else 0

    @property
    def head_vocab(self) -> int:
        return self.vocab_size + self.num_sep_tokens

    def scale_seg_len(self, si: int) -> int:
        """Token count of scale si (all interleaved segments + separators)."""
        pn = self.patch_nums[si]
        num_sp = 1 if (si != 0 and self.separator) else 0
        return (pn * pn + num_sp) * self.mask_factor


def _shape_from_depth(depth: int) -> dict:
    return dict(
        depth=depth,
        embed_dim=depth * 64,
        num_heads=depth,
        drop_path_rate=0.1 * depth / 24,
    )


def var_config_from_depth(depth: int, **overrides) -> VARConfig:
    kw = _shape_from_depth(depth)
    kw.update(overrides)
    return VARConfig(**kw)


def control_var_config_from_depth(
    depth: int, mask_type: str = "interleave_append", **overrides
) -> ControlVARConfig:
    kw = _shape_from_depth(depth)
    kw["mask_factor"] = {"replace": 1, "interleave_append": 2}[mask_type]
    # cos-attn is force-enabled at depth 30
    kw["cos_attn"] = overrides.pop("cos_attn", depth == 30)
    kw.update(overrides)
    return ControlVARConfig(**kw)


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """AdamW with per-step lr/wd annealing."""

    base_lr: float = 1e-4         # scaled by total_batch/512
    total_batch_size: int = 64
    weight_decay: float = 0.05
    weight_decay_end: Optional[float] = None  # anneal target; None = constant
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 2.0
    warmup_epochs: float = 1.0    # wp
    warmup_init_frac: float = 0.005  # wp0
    final_lr_frac: float = 0.015  # wpe-style final fraction
    schedule: str = "lin0"        # {cos, lin, lin0, lin00, linT, exp}
    epochs: int = 30
    grad_accum: int = 1           # microbatches per optimizer step

    @property
    def lr(self) -> float:
        return self.base_lr * self.total_batch_size / 512

    @property
    def wd_end(self) -> float:
        return self.weight_decay if self.weight_decay_end is None else self.weight_decay_end


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    """Default CFG sampling recipe."""

    cfg: Tuple[float, float, float] = (4.0, 4.0, 4.0)
    top_k: int = 900
    top_p: float = 0.96
    seed: int = 42
    more_smooth: bool = False
    # opt-in scale-aware KV window (lossy; segmented cache mode)
    kv_window: Optional[int] = None
