"""Multi-scale residual vector quantizer.

Coarse-to-fine residual VQ over a pyramid of token maps: per scale the
residual feature is area-downsampled to (pn, pn), matched against one shared
(V, Cvae) codebook, the chosen embeddings are bicubic-upsampled back to full
resolution, refined by a partially-shared 3x3 "phi" conv, and subtracted from
the residual. Feature maps are NHWC, as in the JAX package.

All quantizer math runs in fp32 with TF32 off (`device.no_tf32`): the codebook
argmin must see full-precision distances, or token streams drift.

Params: {"embedding": (V, Cvae),
         "phi": [{"kernel": (Cvae, Cvae, 3, 3) OIHW, "bias": (Cvae,)} x K]}
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from controlvar_tpu_torch.config import VQVAEConfig
from controlvar_tpu_torch.device import no_tf32
from controlvar_tpu_torch.ops.resize import resize_area, resize_bicubic

Params = Dict


def phi_index_table(num_scales: int, num_phi: int) -> Tuple[int, ...]:
    """Static scale -> phi assignment: K phis sit at ticks over the [0, 1]
    scale-ratio range and scale si uses the tick nearest si/(num_scales-1)."""
    if num_phi <= 0:
        return tuple(0 for _ in range(num_scales))
    if num_phi == 4:
        ticks = np.linspace(1 / 3 / num_phi, 1 - 1 / 3 / num_phi, num_phi)
    else:
        ticks = np.linspace(1 / 2 / num_phi, 1 - 1 / 2 / num_phi, num_phi)
    out = []
    for si in range(num_scales):
        ratio = si / (num_scales - 1) if num_scales > 1 else 0.0
        out.append(int(np.argmin(np.abs(ticks - ratio))))
    return tuple(out)


def _phi_apply(phi_params: Params, x: torch.Tensor, resi_ratio: float) -> torch.Tensor:
    """phi(x) = (1-r)*x + r*conv3x3(x) on NHWC fp32."""
    y = F.conv2d(x.permute(0, 3, 1, 2), phi_params["kernel"], phi_params["bias"],
                 padding=1).permute(0, 2, 3, 1)
    return x * (1.0 - resi_ratio) + y * resi_ratio


@dataclasses.dataclass(frozen=True)
class MultiScaleQuantizer:
    """Stateless quantizer bound to a static VQVAEConfig; works on the
    device of the tensors it is given."""

    cfg: VQVAEConfig

    def init_params(self, generator: torch.Generator) -> Params:
        """torch-default inits: N(0, 1) codebook, U(+-1/sqrt(fan_in)) phis."""
        cfg = self.cfg
        C = cfg.z_channels
        embedding = torch.randn(cfg.vocab_size, C, generator=generator)
        n_phi = cfg.share_quant_resi if cfg.share_quant_resi > 0 else cfg.num_scales
        bound = 1.0 / np.sqrt(9 * C)
        phis = []
        for _ in range(n_phi):
            k = (torch.rand(C, C, 3, 3, generator=generator) * 2 - 1) * bound
            b = (torch.rand(C, generator=generator) * 2 - 1) * bound
            phis.append({"kernel": k, "bias": b})
        return {"embedding": embedding, "phi": phis}

    @property
    def _phi_table(self) -> Tuple[int, ...]:
        return phi_index_table(self.cfg.num_scales, self.cfg.share_quant_resi)

    def _phi(self, params: Params, si: int, x: torch.Tensor) -> torch.Tensor:
        if abs(self.cfg.quant_resi) <= 1e-6:
            return x
        return _phi_apply(params["phi"][self._phi_table[si]], x,
                          abs(self.cfg.quant_resi))

    # ---- codebook search --------------------------------------------------

    def nearest_code(self, params: Params, z_nc: torch.Tensor) -> torch.Tensor:
        """argmin_v ||z - E_v||^2 as one matmul. z: (..., C) -> int64 ids.
        Ties go to the first index, as in jnp.argmin."""
        E = params["embedding"].float()
        z = z_nc.float()
        with no_tf32():
            if self.cfg.using_znorm:
                zn = z / z.norm(dim=-1, keepdim=True).clamp_min(1e-12)
                En = E / E.norm(dim=-1, keepdim=True).clamp_min(1e-12)
                return torch.argmax(zn @ En.T, dim=-1)
            # |z|^2 is constant per row -> dropped
            d = (E * E).sum(-1) - 2.0 * (z @ E.T)
        return torch.argmin(d, dim=-1)

    def embed(self, params: Params, ids: torch.Tensor) -> torch.Tensor:
        """Codebook lookup: int ids (...,) -> (..., Cvae) fp32."""
        return params["embedding"].float()[ids]

    # ---- encode: feature map -> per-scale token ids -------------------------

    def encode_ids(self, params: Params, f_bhwc: torch.Tensor,
                   patch_nums: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
        """f (B, H, W, Cvae) -> [(B, pn*pn) int64] per scale."""
        pns = tuple(patch_nums or self.cfg.patch_nums)
        B, H, W, C = f_bhwc.shape
        assert pns[-1] == H == W, f"last scale {pns[-1]} must equal feature size {H}"
        f_rest = f_bhwc.float()
        SN = len(pns)
        all_ids: List[torch.Tensor] = []
        with no_tf32():
            for si, pn in enumerate(pns):
                z = resize_area(f_rest, pn, pn) if si != SN - 1 else f_rest
                idx = self.nearest_code(params, z)              # (B, pn, pn)
                h = self.embed(params, idx)                     # (B, pn, pn, C)
                if si != SN - 1:
                    h = resize_bicubic(h, H, W)
                h = self._phi(params, si, h)
                f_rest = f_rest - h
                all_ids.append(idx.reshape(B, pn * pn))
        return all_ids

    # ---- AR decode-step residual update --------------------------------------

    def next_ar_input(self, params: Params, si: int, f_hat: torch.Tensor,
                      h_bhwc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One decode-step canvas update. h_bhwc: (B, pn, pn, C) embedded
        tokens of scale si. Returns (new f_hat (B,H,W,C), next-scale input
        map (B,pn',pn',C))."""
        pns = self.cfg.patch_nums
        SN = len(pns)
        H = W = pns[-1]
        with no_tf32():
            if si != SN - 1:
                h = self._phi(params, si, resize_bicubic(h_bhwc, H, W))
                f_hat = f_hat + h
                return f_hat, resize_area(f_hat, pns[si + 1], pns[si + 1])
            f_hat = f_hat + self._phi(params, si, h_bhwc)
        return f_hat, f_hat
