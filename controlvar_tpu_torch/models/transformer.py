"""AdaLN self-attention transformer: the training forward and KV-cached decode.

One block type: pre-norm (no affine) with per-condition (gamma1, gamma2,
scale1, scale2, shift1, shift2) modulation, fused QKV with a zero k bias,
1/(sqrt(hd)*tau) scaling or cosine attention, GELU(tanh) MLP. The residual
stream runs in the compute dtype (bf16 on the GPU); LayerNorm statistics,
AdaLN modulation and softmax run in fp32.

The training forward (`blocks_forward`) runs the layers as a Python loop
over views of the stacked params, with attention through `flash_mha`
(kernels K3 forward and K4 backward on the GPU), optional per-sample drop
path, and, when training, per-layer recompute (`torch.utils.checkpoint`)
under one of the JAX package's remat policies, `full` (the default),
`dots` or `dots_attn`.

Decode keeps a preallocated K/V cache per stream, written in place: each
layer-step writes its fresh rows [pos, pos + l) and attention reads rows
[0, pos + l) of that layer through strides, with no copy of the prefix. The
cache's layout follows the JAX package's: paired (depth, B, H, L_max, hd)
K and V for hd = 64 and an even head count, read by K1 (or written and read
by one K6 launch per layer-step, `inplace`); flat, transposed (depth, B, H,
hd, L) K^T and V^T otherwise, read by K7; or, on request for a paired
config, one fused (depth, B, H, L_max, 2 hd) buffer, read by K8. The
segmented mode (`blocks_decode_seg`) keeps one (depth, B, H, l_s, hd)
segment per scale instead, and attends over [kept segments | fresh rows]
with K5.

Stacked params (leading dim = depth), dense kernels as (in, out):
  qkv_kernel (D, C, 3C)   q_bias/v_bias (D, C)
  proj{kernel (D,C,C), bias (D,C)}   fc1{(D,C,hidden)}  fc2{(D,hidden,C)}
  ada_lin{kernel (D, C, 6C), bias (D, 6C)}   scale_mul (D, H) [cos_attn only]
With `shared_aln`, ada_gss (D, 6, C) replaces ada_lin: every layer adds its
own ada_gss to one modulation made by the model-level `shared_ada_lin`
({kernel (C, 6C), bias (6C,)}), which the callers pass as `shared_lin`.

Tensor parallelism: given `tp`, a mesh whose model axis splits the model
(`parallel/mesh.py`), the params are this rank's shard
(`parallel/tensor.py:shard_params`) and the functions run Megatron's
layout: the local head count is read from the shard (qkv_kernel's width),
the column-parallel inputs (qkv, fc1, ada_lin, head) pass `copy_to_model`,
the row-parallel outputs (proj, fc2) are summed over the model group before
their replicated bias is added once, and the AdaLN modulations and the
logits are gathered whole. A leaf kept whole (heads that do not divide)
runs as without tp. tp=None is the single-device path, unchanged.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from controlvar_tpu_torch.config import VARConfig
from controlvar_tpu_torch.ops.attention import (decode_attention, decode_attention_flat,
                                                decode_attention_fused, decode_attention_inplace,
                                                decode_attention_prefix, flash_mha)
from controlvar_tpu_torch.parallel.tensor import (copy_to_model, gather_from_model,
                                                  reduce_from_model)

Params = Dict

MAX_COS_SCALE = float(np.log(100.0))


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-free LayerNorm with fp32 statistics, cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _trunc_normal(g: torch.Generator, shape, std: float) -> torch.Tensor:
    """torch.nn.init.trunc_normal_(std=s): truncation at ABSOLUTE +-2, which
    for the small stds used here is a plain normal in practice."""
    if 2.0 / std >= 10.0:
        return std * torch.randn(*shape, generator=g)
    t = torch.empty(*shape)
    return torch.nn.init.trunc_normal_(t, std=std, a=-2.0, b=2.0, generator=g)


def init_block_params(g: torch.Generator, cfg: VARConfig) -> Params:
    """Reference defaults with the depth-scaled special init."""
    C, D = cfg.embed_dim, cfg.depth
    hidden = round(C * cfg.mlp_ratio)
    std = 0.02
    p: Params = {
        "qkv_kernel": _trunc_normal(g, (D, C, 3 * C), std),
        "q_bias": torch.zeros(D, C),
        "v_bias": torch.zeros(D, C),
        "proj": {"kernel": _trunc_normal(g, (D, C, C), std) / np.sqrt(2 * D),
                 "bias": torch.zeros(D, C)},
        "fc1": {"kernel": _trunc_normal(g, (D, C, hidden), std),
                "bias": torch.zeros(D, hidden)},
        "fc2": {"kernel": _trunc_normal(g, (D, hidden, C), std) / np.sqrt(2 * D),
                "bias": torch.zeros(D, C)},
    }
    if cfg.shared_aln:
        gss = torch.randn(D, 6, C, generator=g) / np.sqrt(C)
        gss[:, :2] *= cfg.aln_gamma_init    # gamma rows
        gss[:, 2:] *= cfg.aln_init          # scale/shift rows
        p["ada_gss"] = gss
    else:
        w = _trunc_normal(g, (D, C, 6 * C), std)
        w[:, :, : 2 * C] *= cfg.aln_gamma_init   # gamma columns
        w[:, :, 2 * C:] *= cfg.aln_init          # scale/shift columns
        p["ada_lin"] = {"kernel": w, "bias": torch.zeros(D, 6 * C)}
    if cfg.cos_attn:
        p["scale_mul"] = torch.full((D, cfg.num_heads), float(np.log(4.0)))
    return p


def init_head_params(g: torch.Generator, cfg: VARConfig, head_vocab: int) -> Params:
    C = cfg.embed_dim
    return {
        "head_nm": {"ada_lin": {"kernel": _trunc_normal(g, (C, 2 * C), 0.02) * cfg.aln_init,
                                "bias": torch.zeros(2 * C)}},
        "head": {"kernel": _trunc_normal(g, (C, head_vocab), 0.02),
                 "bias": torch.zeros(head_vocab)},
    }


def _layer(bp: Params, li: int) -> Params:
    """Layer li's views of the stacked block params."""
    return {k: (_layer(v, li) if isinstance(v, dict) else v[li]) for k, v in bp.items()}


def local_heads(bp: Params, cfg: VARConfig) -> int:
    """The head count of a (stacked or layer) block tree: cfg.num_heads, or
    a tensor-parallel shard's share of them."""
    return bp["qkv_kernel"].shape[-1] // (3 * cfg.head_dim)


def _split(tp, local: int, whole: int):
    """tp where a leaf of this width is a shard of the whole one, else None."""
    return tp if tp is not None and local < whole else None


def _qkv(lp: Params, x: torch.Tensor, cfg: VARConfig, tp=None):
    """x (B, L, C) -> q, k, v each (B, H, L, hd), H the shard's heads;
    cos-attn normalization applied."""
    B, L, C = x.shape
    H, hd = local_heads(lp, cfg), cfg.head_dim
    if _split(tp, H, cfg.num_heads) is not None:
        x = copy_to_model(x, tp)
    bias = torch.cat([lp["q_bias"], torch.zeros_like(lp["q_bias"]), lp["v_bias"]], dim=-1)
    qkv = x @ lp["qkv_kernel"].to(x.dtype) + bias.to(x.dtype)
    q, k, v = qkv.reshape(B, L, 3, H, hd).permute(2, 0, 3, 1, 4)  # (3, B, H, L, hd)
    if cfg.cos_attn:
        sm = torch.exp(torch.clamp(lp["scale_mul"].float(), max=MAX_COS_SCALE))
        qf, kf = q.float(), k.float()
        q = (qf / qf.norm(dim=-1, keepdim=True).clamp_min(1e-12)
             * sm[None, :, None, None]).to(x.dtype)
        k = (kf / kf.norm(dim=-1, keepdim=True).clamp_min(1e-12)).to(x.dtype)
    return q, k, v


def _row_parallel_out(y: torch.Tensor, bias: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel product's output y plus its bias: with tp, the fp32
    sum of the model group's partial outputs, the replicated bias added
    once after the sum."""
    if tp is None:
        return y + bias.to(y.dtype)
    return reduce_from_model(y, tp) + bias.float()


def _ffn(lp: Params, x: torch.Tensor, cfg: VARConfig, tp=None) -> torch.Tensor:
    """The MLP; fp32 out of a tensor-parallel shard, x's dtype otherwise."""
    tp = _split(tp, lp["fc1"]["kernel"].shape[-1], round(cfg.embed_dim * cfg.mlp_ratio))
    if tp is not None:
        x = copy_to_model(x, tp)
    h = x @ lp["fc1"]["kernel"].to(x.dtype) + lp["fc1"]["bias"].to(x.dtype)
    h = F.gelu(h, approximate="tanh")
    return _row_parallel_out(h @ lp["fc2"]["kernel"].to(x.dtype), lp["fc2"]["bias"], tp)


def _ada_all_layers(bp: Params, cond: torch.Tensor, cfg: VARConfig,
                    shared_lin: Optional[Params] = None, tp=None) -> torch.Tensor:
    """(depth, B, 6, C) fp32 AdaLN modulations of all layers from the
    condition cond (B, C): one batched matmul of SiLU(cond), in the kernel's
    dtype (bf16 after prepare_params), then fp32 (a shard's columns gathered
    whole); with shared_aln, each layer's ada_gss added to the one fp32
    modulation that the model-level shared_lin makes."""
    cond_act = F.silu(cond.float())
    if cfg.shared_aln:
        shared = cond_act @ shared_lin["kernel"] + shared_lin["bias"]
        return bp["ada_gss"][:, None] + shared.reshape(1, -1, 6, cfg.embed_dim)
    k_ada = bp["ada_lin"]["kernel"]
    tp = _split(tp, k_ada.shape[-1], 6 * cfg.embed_dim)
    if tp is not None:
        cond_act = copy_to_model(cond_act, tp)
    ada = torch.einsum("bc,dce->dbe", cond_act.to(k_ada.dtype), k_ada).float()
    ada = ada + bp["ada_lin"]["bias"].float()[:, None]
    if tp is not None:
        ada = gather_from_model(ada, tp)
    return ada.reshape(cfg.depth, -1, 6, cfg.embed_dim)


def _ada_parts(ada: torch.Tensor, cfg: VARConfig):
    """(g1, g2, s1, s2, sh1, sh2), each (B, 1, C), of a layer's (B, 6, C)
    modulation."""
    return tuple(a.reshape(-1, 1, cfg.embed_dim) for a in ada.unbind(dim=1))


def _attn_in(lp: Params, h: torch.Tensor, ada: torch.Tensor, cfg: VARConfig, tp=None):
    """A layer's attention inputs: AdaLN-modulated pre-norm -> fused QKV."""
    _, _, s1, _, sh1, _ = _ada_parts(ada, cfg)
    hn = layer_norm(h, cfg.norm_eps)
    hn = (hn.float() * (s1 + 1.0) + sh1).to(h.dtype)
    return _qkv(lp, hn, cfg, tp)


def _block_out(lp: Params, h: torch.Tensor, o: torch.Tensor, ada: torch.Tensor,
               cfg: VARConfig, keep: Optional[torch.Tensor] = None, tp=None) -> torch.Tensor:
    """A layer after its attention output o (B, H, L, hd): projection ->
    gamma-gated residual -> modulated FFN residual. keep: optional (2, B)
    drop-path factors (mask / keep rate) of the attention and FFN branches."""
    g1, g2, _, s2, _, sh2 = _ada_parts(ada, cfg)
    B, H, Lq, hd = o.shape
    o = o.transpose(1, 2).reshape(B, Lq, H * hd)
    o = _row_parallel_out(o @ lp["proj"]["kernel"].to(o.dtype), lp["proj"]["bias"],
                          _split(tp, H, cfg.num_heads))
    o = (o.float() * g1).to(h.dtype)
    if keep is not None:
        o = o * keep[0].reshape(B, 1, 1)
    h = h + o
    hn = layer_norm(h, cfg.norm_eps)
    hn = (hn.float() * (s2 + 1.0) + sh2).to(h.dtype)
    f = (_ffn(lp, hn, cfg, tp).float() * g2).to(h.dtype)
    if keep is not None:
        f = f * keep[1].reshape(B, 1, 1)
    return h + f


def _block_body(lp: Params, h: torch.Tensor, ada: torch.Tensor, cfg: VARConfig,
                attn_fn, keep: Optional[torch.Tensor] = None, tp=None) -> torch.Tensor:
    """One layer: `_attn_in`, attention, `_block_out`."""
    return _block_out(lp, h, attn_fn(*_attn_in(lp, h, ada, cfg, tp)), ada, cfg, keep, tp)


def _drop_path(generator: torch.Generator, rates, batch: int,
               dtype: torch.dtype) -> torch.Tensor:
    """(depth, 2, B) per-sample stochastic-depth factors mask / keep, in
    `dtype`, for the attention and FFN branch of every layer: mask ~
    Bernoulli(keep = 1 - rate) drawn as uniform < keep, as jax.random.
    bernoulli does. Drawn for all layers before the layer loop, as JAX splits
    its keys before the scan: torch.utils.checkpoint does not restore an
    explicit generator, so a draw inside a recomputed layer would differ."""
    keep = 1.0 - torch.as_tensor(rates, dtype=torch.float32)
    u = torch.rand(len(keep), 2, batch, generator=generator)
    mask = (u < keep[:, None, None]).to(dtype)
    return mask / keep.to(dtype)[:, None, None]


def _unbind_layers(bp: Params, depth: int):
    """Per-layer views of the stacked block params, made with one unbind per
    leaf, so the backward stacks each leaf's gradient once instead of
    scattering every layer's into a zeroed full-depth copy. ada_lin (or
    ada_gss) is left out: all layers' modulations are made at once."""
    def unbind(tree):
        if isinstance(tree, dict):
            return {k: unbind(v) for k, v in tree.items() if k not in ("ada_lin", "ada_gss")}
        return tree.unbind(0)

    def pick(tree, li):
        return {k: (pick(v, li) if isinstance(v, dict) else v[li]) for k, v in tree.items()}

    views = unbind(bp)
    return [pick(views, li) for li in range(depth)]


REMAT_POLICIES = ("full", "dots", "dots_attn")
# the 2-D weight matmuls of a layer (qkv, proj, fc1, fc2) reach the
# dispatcher as aten.mm (x @ W) or aten.addmm; attention's batched products
# are bmm and are not saved, as dots_with_no_batch_dims_saveable saves none
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of `dots`: keep the weight-matmul outputs,
    recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


_dots_context = functools.partial(create_selective_checkpoint_contexts, _save_dots)
_CKPT = dict(use_reentrant=False, preserve_rng_state=False)  # no draws inside a layer


def blocks_forward(bp: Params, x: torch.Tensor, cond: torch.Tensor, cfg: VARConfig,
                   mask: torch.Tensor, *, flags: Optional[torch.Tensor] = None,
                   train: bool = False, generator: Optional[torch.Generator] = None,
                   remat: str = "full", shared_lin: Optional[Params] = None,
                   tp=None) -> torch.Tensor:
    """Full-sequence forward through all blocks, attention through
    `flash_mha` (K3/K4 on the GPU).

    x: (B, L, C) residual stream (bf16 on the GPU); cond: (B, C) fp32;
    mask: (L, L) bool on x's device, flags its `tile_flags`; shared_lin:
    the model's shared_ada_lin under shared_aln; tp: the mesh of a
    tensor-parallel shard (module docstring). With train and
    a generator, drop path is drawn from the generator. With train, each
    layer is recomputed in the backward under the remat policy (the JAX
    package's `_remat_wrap`; it changes what is saved, never the math):
      full:      only the per-layer residual stream is kept (the default);
      dots:      the weight-matmul outputs (qkv, proj, fc1, fc2) are kept
                 too, so the recompute skips them;
      dots_attn: as dots, and the layer is checkpointed as two segments
                 around the attention, whose output (with q, k, v and the
                 LSE, saved by `flash_mha` for K4) is kept: the backward
                 never reruns K3.
    """
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat={remat!r}: want one of {'|'.join(REMAT_POLICIES)}")
    D, B = cfg.depth, x.shape[0]
    ada_all = _ada_all_layers(bp, cond, cfg, shared_lin, tp)
    keep = None
    if train and generator is not None and cfg.drop_path_rate > 0:
        rates = np.linspace(0.0, cfg.drop_path_rate, D, dtype=np.float32)
        keep = _drop_path(generator, rates, B, x.dtype).to(x.device)
    scale = 1.0 if cfg.cos_attn else cfg.attn_scale
    attn_fn = lambda q, k, v: flash_mha(q, k, v, mask, scale, flags)
    for li, lp in enumerate(_unbind_layers(bp, D)):
        k_li = None if keep is None else keep[li]
        if not train:
            x = _block_body(lp, x, ada_all[li], cfg, attn_fn, k_li, tp)
        elif remat == "full":
            x = checkpoint(_block_body, lp, x, ada_all[li], cfg, attn_fn, k_li, tp, **_CKPT)
        elif remat == "dots":
            x = checkpoint(_block_body, lp, x, ada_all[li], cfg, attn_fn, k_li, tp,
                           context_fn=_dots_context, **_CKPT)
        else:
            q, k, v = checkpoint(_attn_in, lp, x, ada_all[li], cfg, tp,
                                 context_fn=_dots_context, **_CKPT)
            x = checkpoint(_block_out, lp, x, attn_fn(q, k, v), ada_all[li], cfg, k_li, tp,
                           context_fn=_dots_context, **_CKPT)
    return x


def kv_layout(cfg: VARConfig) -> str:
    """The JAX package's cache-layout rule (`controlvar_tpu/models/
    transformer.py:kv_layout`): 'paired' for hd = 64 and an even head count,
    else 'flat'. It picks the stacked cache's layout (`init_kv_cache`) and,
    as in the JAX package, whether a sampler may take the segmented mode."""
    return "paired" if (cfg.head_dim == 64 and cfg.num_heads % 2 == 0) else "flat"


def kv_fused(cfg: VARConfig, requested: bool) -> bool:
    """The JAX package's `kv_fused` rule without its environment read: the
    fused cache layout applies to a paired-layout config only."""
    return requested and kv_layout(cfg) == "paired"


def init_kv_cache(cfg: VARConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cpu", fused: bool = False,
                  heads: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed K and V caches in the layout `blocks_decode` reads, one head a
    row (the JAX package pairs two heads a row for the TPU's 128 lanes), for
    `heads` heads (cfg.num_heads; a tensor-parallel shard's `local_heads`):
      paired: K and V, each (depth, B, H, max_len, hd);
      flat:   K^T and V^T, each (depth, B, H, hd, L), L = max_len rounded up
              to a multiple of 8 so that every row starts 16-byte aligned;
      fused (`kv_fused(cfg, fused)`): ONE (depth, B, H, max_len, 2 hd)
              buffer of rows [k_h | v_h] and an empty placeholder for V."""
    D, H, hd = cfg.depth, heads or cfg.num_heads, cfg.head_dim
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    if kv_fused(cfg, fused):
        return zeros(D, batch, H, max_len, 2 * hd), zeros(0)
    if kv_layout(cfg) == "flat":
        L = -(-max_len // 8) * 8
        return zeros(D, batch, H, hd, L), zeros(D, batch, H, hd, L)
    return zeros(D, batch, H, max_len, hd), zeros(D, batch, H, max_len, hd)


def blocks_decode(bp: Params, x: torch.Tensor, cond: torch.Tensor, cfg: VARConfig,
                  cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
                  mask_slice: Optional[torch.Tensor] = None, inplace: bool = False,
                  shared_lin: Optional[Params] = None, tp=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One KV-cached decode step over all blocks.

    x: (B, l, C) tokens of the current scale; pos: first cache row they take.
    mask_slice: optional (l, pos + l) bool mask; None = attend to everything
    cached. shared_lin: the model's shared_ada_lin under shared_aln; tp: the
    mesh of a tensor-parallel shard, whose caches hold its heads. The
    caches (`init_kv_cache`) are updated in place and returned.
    Each layer writes its fresh rows, then attends over rows [0, pos + l),
    by the caches' layout: the fused buffer (an empty V placeholder) through
    K8, the flat layout (`kv_layout`) through K7 after a transposed write,
    the paired layout through K1, or, with inplace and no mask, one K6
    launch per layer that does both (the JAX package's
    CONTROLVAR_INPLACE_DECODE=1; a masked step keeps the split path there
    too). inplace needs the paired layout.
    """
    l = x.shape[1]
    cur = pos + l
    ada_all = _ada_all_layers(bp, cond, cfg, shared_lin, tp)
    scale = 1.0 if cfg.cos_attn else cfg.attn_scale
    fused = cache_v.dim() == 1
    flat = not fused and kv_layout(cfg) == "flat"
    if inplace and (fused or flat):
        raise ValueError("inplace decode needs the paired, unfused cache layout")
    inplace = inplace and mask_slice is None
    for li in range(cfg.depth):
        def attn_fn(q, k, v, li=li):
            if inplace:
                return decode_attention_inplace(q, cache_k, cache_v, k, v, li, pos, scale)
            if fused:
                cache_k[li, :, :, pos:cur] = torch.cat([k, v], dim=-1)
                return decode_attention_fused(q, cache_k, li, cur, scale, mask_slice)
            if flat:
                cache_k[li, ..., pos:cur] = k.transpose(2, 3)
                cache_v[li, ..., pos:cur] = v.transpose(2, 3)
                return decode_attention_flat(q, cache_k, cache_v, li, cur, scale, mask_slice)
            cache_k[li, :, :, pos:cur] = k
            cache_v[li, :, :, pos:cur] = v
            return decode_attention(q, cache_k, cache_v, li, cur, scale, mask_slice)

        x = _block_body(_layer(bp, li), x, ada_all[li], cfg, attn_fn, tp=tp)
    return x, cache_k, cache_v


def blocks_decode_seg(bp: Params, x: torch.Tensor, cond: torch.Tensor, cfg: VARConfig,
                      segs_k: Tuple[torch.Tensor, ...], segs_v: Tuple[torch.Tensor, ...],
                      mask_slice: Optional[torch.Tensor] = None,
                      shared_lin: Optional[Params] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step over segmented per-scale caches.

    segs_k/segs_v: the kept earlier scales' K/V, each (depth, B, H, l_s,
    hd); pos = sum of their l_s. Returns (y, k_seg, v_seg), this scale's
    (depth, B, H, l, hd) segments, for the caller to append. Scale 0 (pos
    == 0) attends over its fresh rows with K1; later scales attend over
    [kept segments | fresh rows] with K5. mask_slice: optional (l, pos + l);
    shared_lin as in `blocks_decode`.
    """
    B, l = x.shape[:2]
    pos = sum(s.shape[3] for s in segs_k)
    ada_all = _ada_all_layers(bp, cond, cfg, shared_lin)
    scale = 1.0 if cfg.cos_attn else cfg.attn_scale
    shape = (cfg.depth, B, cfg.num_heads, l, cfg.head_dim)
    k_seg, v_seg = x.new_empty(shape), x.new_empty(shape)
    if pos:
        # The kept segments are concatenated once per scale step, and K5
        # reads layer li of the copy through strides. The copy writes and
        # reads back 2 x depth*B*H*pos*hd elements: at the d24 joint path's
        # final scale (16 CFG rows, pos = 848) 2 x 1.0 GB of bf16, ~1.2 ms at
        # 3.35 TB/s, once, against 24 K5 launches that read the same bytes.
        pre_k, pre_v = torch.cat(segs_k, dim=3), torch.cat(segs_v, dim=3)
    for li in range(cfg.depth):
        def attn_fn(q, k, v, li=li):
            k_seg[li], v_seg[li] = k, v
            if pos == 0:
                return decode_attention(q, k_seg, v_seg, li, l, scale, mask_slice)
            return decode_attention_prefix(q, pre_k[li], pre_v[li], k_seg[li], v_seg[li],
                                           scale, mask_slice)

        x = _block_body(_layer(bp, li), x, ada_all[li], cfg, attn_fn)
    return x, k_seg, v_seg


def _vocab_projection(p: Params, h: torch.Tensor, cfg: VARConfig, tp) -> torch.Tensor:
    """h @ head + bias in fp32; a shard's vocabulary columns gathered whole."""
    if tp is not None:
        tp = _split(tp, p["head"]["kernel"].shape[-1], cfg.head_vocab)
    if tp is None:
        return h @ p["head"]["kernel"] + p["head"]["bias"]
    return gather_from_model(copy_to_model(h, tp) @ p["head"]["kernel"] + p["head"]["bias"], tp)


def head_logits(p: Params, x: torch.Tensor, cond: torch.Tensor,
                cfg: VARConfig, tp=None) -> torch.Tensor:
    """AdaLN-modulated LayerNorm, then the vocab projection, in fp32 (whole
    logits on every rank of a tensor-parallel shard tp)."""
    ada = F.silu(cond.float()) @ p["head_nm"]["ada_lin"]["kernel"] + p["head_nm"]["ada_lin"]["bias"]
    scale, shift = ada.reshape(-1, 2, cfg.embed_dim).split(1, dim=1)
    h = layer_norm(x.float(), cfg.norm_eps)
    h = h * (scale + 1.0) + shift
    return _vocab_projection(p, h, cfg, tp)


def head_logits_cfg(p: Params, x: torch.Tensor, cond: torch.Tensor,
                    cfg: VARConfig, weights, tp=None) -> torch.Tensor:
    """CFG-combined head logits in one reduced matmul, fp32 (whole logits
    on every rank of a tensor-parallel shard tp).

    x: (R*B, seg, C) final hidden states of the R CFG branches; weights: R
    floats summing to 1. The vocab projection is linear, so the branches are
    combined after the per-branch AdaLN-LN and before the C x V matmul."""
    assert abs(sum(weights) - 1.0) < 1e-6
    R = len(weights)
    B = x.shape[0] // R
    cond_act = F.silu(cond.float())
    ada = cond_act @ p["head_nm"]["ada_lin"]["kernel"] + p["head_nm"]["ada_lin"]["bias"]
    scale, shift = ada.reshape(-1, 2, cfg.embed_dim).split(1, dim=1)
    h = layer_norm(x.float(), cfg.norm_eps)
    h = h * (scale + 1.0) + shift                       # (R*B, seg, C)
    # python-float weights: no host->device copy (which would wait for the
    # GPU queue) in the middle of a scale step
    hc = sum(w * hr for w, hr in zip(weights, h.split(B)))
    return _vocab_projection(p, hc, cfg, tp)
