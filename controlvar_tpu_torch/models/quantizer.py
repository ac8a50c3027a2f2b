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
        ids, _ = self._encode(params, f_bhwc, patch_nums, want_fhat=False)
        return ids

    def encode_fhat(self, params: Params, f_bhwc: torch.Tensor,
                    patch_nums: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
        """Per-scale cumulative reconstructions f_hat (B, H, W, C), fp32."""
        _, fhats = self._encode(params, f_bhwc, patch_nums, want_fhat=True)
        return fhats

    def _encode(self, params, f_bhwc, patch_nums, want_fhat):
        pns = tuple(patch_nums or self.cfg.patch_nums)
        B, H, W, C = f_bhwc.shape
        assert pns[-1] == H == W, f"last scale {pns[-1]} must equal feature size {H}"
        f_rest = f_bhwc.float()
        f_hat = torch.zeros_like(f_rest)
        SN = len(pns)
        all_ids: List[torch.Tensor] = []
        all_fhat: List[torch.Tensor] = []
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
                if want_fhat:
                    f_hat = f_hat + h
                    all_fhat.append(f_hat)
        return all_ids, all_fhat

    # ---- teacher-forcing inputs for training -----------------------------------

    def ids_to_var_input(self, params: Params,
                         ms_ids: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Ground-truth per-scale ids -> teacher-forcing features: for each
        scale k in [1, SN), the f_hat accumulated over scales < k,
        area-downsampled to (pn_k, pn_k) and flattened to (B, pn_k^2, Cvae)."""
        pns = self.cfg.patch_nums
        B = ms_ids[0].shape[0]
        H = W = pns[-1]
        C = self.cfg.z_channels
        f_hat = torch.zeros(B, H, W, C, device=ms_ids[0].device)
        out: List[torch.Tensor] = []
        with no_tf32():
            for si in range(len(pns) - 1):
                pn, pn_next = pns[si], pns[si + 1]
                h = resize_bicubic(self.embed(params, ms_ids[si].reshape(B, pn, pn)), H, W)
                f_hat = f_hat + self._phi(params, si, h)
                nxt = resize_area(f_hat, pn_next, pn_next)
                out.append(nxt.reshape(B, pn_next * pn_next, C))
        return out

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

    # ---- embeddings -> f_hat (visualization / decode) -------------------------

    def embed_to_fhat(self, params: Params, ms_h: Sequence[torch.Tensor],
                      last_one: bool = False, all_to_max_scale: bool = True):
        """Per-scale raw token embeddings (B, pn, pn, C) -> cumulative f_hat.

        all_to_max_scale=True accumulates at full resolution, as training
        does (reference: models/quant.py:161-170); False is the per-scale
        resolution variant that upsamples the canvas progressively
        (reference: models/quant.py:171-180)."""
        pns = self.cfg.patch_nums
        SN = len(pns)
        H = W = pns[-1]
        B = ms_h[0].shape[0]
        dev = ms_h[0].device
        outs = []
        with no_tf32():
            if all_to_max_scale:
                f_hat = torch.zeros(B, H, W, self.cfg.z_channels, device=dev)
                for si in range(SN):
                    h = ms_h[si]
                    if si < SN - 1:
                        h = resize_bicubic(h, H, W)
                    f_hat = f_hat + self._phi(params, si, h)
                    if not last_one:
                        outs.append(f_hat)
            else:
                f_hat = torch.zeros(B, pns[0], pns[0], self.cfg.z_channels, device=dev)
                for si, pn in enumerate(pns):
                    f_hat = resize_bicubic(f_hat, pn, pn)
                    f_hat = f_hat + self._phi(params, si, ms_h[si])
                    if not last_one:
                        outs.append(f_hat)
        return f_hat if last_one else outs

    def ids_to_fhat(self, params: Params, ms_ids: Sequence[torch.Tensor]) -> torch.Tensor:
        """Full decode of per-scale ids -> final f_hat (B, H, W, C)."""
        B = ms_ids[0].shape[0]
        ms_h = [self.embed(params, ms_ids[si].reshape(B, pn, pn))
                for si, pn in enumerate(self.cfg.patch_nums)]
        return self.embed_to_fhat(params, ms_h, last_one=True)

    # ---- VQVAE-training forward (straight-through) ----------------------------

    def quantize_train(self, params: Params, f_bhwc: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Training-mode quantization with the straight-through estimator.

        Returns (f_hat_st, vq_loss, hits (S, V) per-scale codebook hit
        counts, fp32). The commitment/codebook loss averages
        beta * MSE(f_hat.detach(), f) + MSE(f_hat, f.detach()) over scales,
        and the straight-through output is f + (f_hat - f).detach()
        (reference: models/quant.py:50-102), detached where the JAX package
        stops gradients."""
        cfg = self.cfg
        f = f_bhwc.float()
        f_ng = f.detach()
        f_rest = f_ng
        f_hat = torch.zeros_like(f_ng)
        SN = cfg.num_scales
        H = W = cfg.patch_nums[-1]
        vq_loss = 0.0
        hits = []
        with no_tf32():
            for si, pn in enumerate(cfg.patch_nums):
                z = resize_area(f_rest, pn, pn) if si != SN - 1 else f_rest
                idx = self.nearest_code(params, z)
                hits.append(torch.bincount(idx.reshape(-1), minlength=cfg.vocab_size).float())
                h = self.embed(params, idx)  # grads flow to the embedding
                if si != SN - 1:
                    h = resize_bicubic(h, H, W)
                h = self._phi(params, si, h)
                f_hat = f_hat + h
                f_rest = f_rest - h.detach()
                vq_loss = vq_loss + cfg.beta * torch.mean((f_hat.detach() - f) ** 2) \
                    + torch.mean((f_hat - f_ng) ** 2)
        vq_loss = vq_loss / SN
        f_hat_st = f + (f_hat - f).detach()
        return f_hat_st, vq_loss, torch.stack(hits)

    # ---- codebook usage tracking (EMA) + entropy regularizer ------------------

    def init_usage_state(self, device) -> Dict:
        """The reference's `ema_vocab_hit_SV` buffer and `record_hit` counter
        (reference: models/quant.py:33,86-92) as a tree on `device`. Under
        data parallelism the caller sums the hit counts over the ranks
        first (the reference all-reduces them, quant.py:77,86-87)."""
        return {
            "ema_hits": torch.zeros(self.cfg.num_scales, self.cfg.vocab_size, device=device),
            "record_hit": torch.zeros((), dtype=torch.int32, device=device),
        }

    def update_usage(self, state: Dict, hits_sv: torch.Tensor) -> Dict:
        """EMA update with the reference's warm-up schedule: copy on the first
        step, rate 0.1 for the first 100 steps, 0.01 after
        (reference: models/quant.py:88-92). Returns a new state."""
        n = state["record_hit"]
        rate = torch.where(n == 0, 1.0, torch.where(n < 100, 0.1, 0.01))
        ema = state["ema_hits"] * (1.0 - rate) + hits_sv * rate
        return {"ema_hits": ema, "record_hit": n + 1}

    def usage_percent(self, state: Dict, batch_tokens_per_scale: int) -> torch.Tensor:
        """(S,) percent of codebook entries whose EMA hit count reaches the
        dead-code margin (reference: models/quant.py:99-101): margin =
        world * (numel/C) / V * 0.08, with world folded into
        batch_tokens_per_scale = global B * H * W."""
        margin = batch_tokens_per_scale / self.cfg.vocab_size * 0.08
        return (state["ema_hits"] >= margin).float().mean(dim=-1) * 100.0

    def entropy_loss(self, state: Dict) -> torch.Tensor:
        """-beta * sum p log p over the normalized EMA hit distribution
        (reference: models/quant.py:105-109)."""
        p = state["ema_hits"] / state["ema_hits"].sum().clamp_min(1e-10)
        return -torch.sum(p * torch.log(p + 1e-10)) * self.cfg.beta
