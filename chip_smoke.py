#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (controlvar_tpu_torch) on one GPU.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout. Phases, each fatal on failure:
  1. environment: the card's name and power limit (nvidia-smi);
  2. build every kernel from controlvar_tpu_torch/csrc with nvcc (sm_90a),
     one nvcc per source, all started together;
  3. K1 decode attention vs its plain version, q strided as the fused QKV
     gives it, at every scale's (l, cur) of the serving path, at the final
     scale under an `indep` mask, at every scale of the d24 joint path's
     stacked cache (16 CFG rows x 24 heads) and at B*H = 70,000 heads (cur
     64, l 8); its and SDPA's device times at every serving scale and
     summed over one call (x 16); then at every scale's (l, cur) of the d16
     separator joint path (16 CFG rows, l = 2 (pn^2 + 1), cur up to 1378),
     with its and SDPA's times per scale and per call; then at every serving
     scale over a tensor-parallel rank's cache (model=2: 8 of the 16 heads),
     with its, the plain version's and SDPA's times at the final scale,
     and at every scale of the separator joint path on such a rank (16 CFG
     rows, 8 heads, cur up to 1378), timed at its final scale;
  4. K2 bisection sampling vs its plain version on the same noise at every
     scale's row count (top-k alone: the same ids on every row; with top-p:
     on >= 0.999 of them), on tied and on flat logits, at V = 1000, with
     top-k 0 and top-p, and with top-k >= V; then greedy, Philox and kept-set checks at
     the final scale, the distribution of 1e4 Philox draws (and of the
     unfiltered categorical, whose noise is made on the card) against the
     analytic softmax, and its device time at every scale's row count;
  5. K3 flash attention forward and K4 backward vs their plain versions at
     the d16 training shape (8, 16, 1360, 64) under the block-causal mask,
     at the VAR-d16 one (8, 16, 680, 64: a 40-row last tile) under its
     block-causal mask, at the d16 separator one (8, 16, 1378, 64: scale
     edges off the 64-row tiles, a 34-row last tile) under its block-causal
     mask, under a random pattern of 64 x 64 tiles (fully
     masked tiles anywhere, the diagonal kept) and at a tensor-parallel
     rank's shapes (8, 8, 1360, 64) and, separator, (8, 8, 1378, 64),
     with q, k, v and dO strided
     as the training path gives them, and at a small ragged shape under a causal
     mask; K3 also with rows that attend nowhere and at a scale that is not
     a power of two (0.9/32); K3 and K4 each run twice on the same inputs
     give the same bits; with their times, the plain versions' and SDPA's
     (forward, and its autograd backward) at the three training shapes and
     at the tensor-parallel rank's two;
  6. K5 prefix decode vs its plain version at every scale's (pos, l) of
     the d24 joint path's segmented cache (16 CFG rows, 24 heads), over the
     full prefix and over the kv_window=2 one, on the views
     blocks_decode_seg gives it, then on masked and ragged shapes (pos off
     and on the 64-row tiles, l < 64 and l > 128, pos = 0) and under the
     `indep` mask's slice at the final scale; K6 in-place decode vs its
     plain version at every scale's (pos, l) of the joint path (scale 0 is
     pos == 0), each with a check that it changed exactly rows [pos, pos +
     l) of layer li; all on the strided views the decode paths give them;
     K5's and K6's times and SDPA's over the concatenated K/V at every
     scale and summed over one call (x 24 layers), and at the final scale
     beside the plain versions';
  7. K7 flat decode vs its plain version at every scale's (l, cur) of the
     VAR-d13 path (128 CFG rows, 13 heads of 64, L = 680, the flat layout)
     and at hd 32, 96 and 128 on a ragged masked shape, its and SDPA's
     times at every scale and summed over one call (x 13); K8 fused decode
     bit-equal to K1 on the same rows and vs its plain version at every
     scale of the VAR-d12 path (128 CFG rows, 12 heads), masked and
     unmasked, and at B*H = 70,000 heads, its and SDPA's times at every
     scale and summed over one call (x 12); all on the cache-layer views
     the decode paths give them and
     q strided as the fused QKV gives it; with their times, the plain
     versions' and SDPA's over contiguous K/V made outside the time;
  8. small-input reference: fp32 tokenizer ids on the GPU equal the CPU's;
     one bf16 decode step through each decode kernel (K1; the segmented
     mode, K5; in place, K6; the flat layout of three heads of 64, K7; the
     fused cache, K8; a shared_aln model, K1) agrees with the fp32 CPU
     path; one tiny-config bf16 train step through K3/K4 agrees with the
     fp32 CPU step (loss, and the direction of the whole gradient and of
     each block leaf's), and so does a tiny shared_aln VAR step; the native
     RLE library builds (native.available());
  9. the training path at full width: ControlVAR-d16 (multi_cond), the
     ch-160 VQVAE frozen inside the step, B=8 seeded 256x256 image/mask
     batches, AdamW (OptimConfig(total_batch_size=8)), one warm-up step and
     five timed steps, with K3/K4 launch counts read around each step; then
     one warm-up and three timed steps under each of the remat policies
     dots and dots_attn (K3 32, 32 and 16 a step), with peak memory;
 10. checkpoints: VAR-d16 and the ch-160 VQVAE from seeds, exported,
     written with save_torch_checkpoint, read back and imported onto the
     card, every leaf bit for bit;
 11. the fine-tuning path: VAR-d16 -> ControlVAR-d16 multi_cond surgery
     (concat: pos_1LC == [pos; pos], the blocks equal), LoRA rank 16 /
     alpha 32 on the training path's batches, one warm-up and three timed
     steps (the base unchanged and without gradients, every B non-zero),
     the LoRA state saved with CheckpointIO and restored into a fresh state
     (params, Adam moments on the card, step equal), and merge_lora ->
     export -> import bit for bit;
 12. the VAR training path: VAR-d16 (configs/train_var_imagenet_d16.yaml:
     drop path 0.1, cond drop 0.1, lr 1e-5, wd 1e-4, cosine), B=8 seeded
     256x256 images tokenized inside the step, one warm-up and five timed
     steps, K3/K4 counted; then a tiny bf16 VAR step on the card against
     the fp32 CPU step (loss, gradient cosines);
 13. the serving path at full width: ControlVAR-d16 (multi_cond) and the
     ch-160 VQVAE, random weights from a seed,
     SamplingHarness.control_conditioned on 16 seeded 256x256 control images
     (tokenize, 10 scales with 4-way CFG, top-k 900, top-p 0.96, decode both
     canvases), one warm-up call and one timed call, with K1/K2 launch
     counts read around each call;
 14. the joint path at full width: ControlVAR-d24 (multi_cond) and the
     ch-160 VQVAE, random weights from a seed, SamplingHarness.joint on B=8
     (labels arange(8), cond types i % 4; 10 scales with 2-way CFG 4.0,
     top-k 900, top-p 0.96, decode both canvases) in three cache modes:
     stacked (K1), kv_window=2 (K1 at scale 0, K5 after) and stacked with
     inplace_decode (K6); one warm-up and one timed call each, then four
     rounds that call every mode once in a rotated order (the median of
     each mode's four calls), with the launch counts of K1, K2, K5 and K6
     read around every call;
 15. the VAR path at full width (BASELINE config 2): VAR-d12 and the ch-160
     VQVAE, random weights from a seed, StepwiseVARSampler on B=64 (labels
     arange(64); 10 scales with 2-way CFG 1.5, top-k 900, top-p 0.96, images
     decoded) with the stacked cache (K1 120 launches a call) and with
     kv_fused (K8 120), one warm-up and one timed call each and four
     alternated rounds; then VAR-d13, whose 13 heads take the flat layout
     (K7 130), one warm-up and one timed call; K2 10 a call in each, the
     launch counts of K1, K2, K7 and K8 read around every call;
 16. the separator data path: SyntheticControlDataset(separator=True)
     through the Loader (B=8, four batches), pretokenize with the ch-160
     VQVAE on the card into four token shards (a warm-up pass, then a
     timed one: samples/s; the ids read_token_shard gives back equal
     img_to_ids of the same batches bit for bit), then TokenShardLoader
     feeding ControlVAR-d16 multi_cond with separator and type_pos (L =
     1378, head vocab 4114) through ControlVARTrainStep(from_tokens=True),
     with the spliced ignore mask 1 and the labels separator targets at
     every separator column: one warm-up and three timed steps (K3/K4
     32/16 a step), s/step and peak memory;
 17. the Trainer path: four token shards written again by pretokenize,
     TokenShardLoader into Trainer(from_tokens=True) on that config,
     optim.epochs=2 (8 steps): two uninterrupted runs to stop_after=6 (the
     run-to-run spread of their params; the second timed: s/step, K3/K4
     32/16 a step), a run stopped at step 3 with its checkpoint and a fresh
     Trainer that resumes it (init_state, maybe_resume) across the epoch
     boundary to step 6, whose params equal the uninterrupted run's bit for
     bit when the spread is 0 (within twice the spread otherwise), each
     CheckpointIO.save timed; then one more step inside a world-size-1 NCCL
     process group (one all-reduce of the gradients), bit-equal to the same
     step without a group, the group destroyed after;
 18. tokenizer training: a tiny MaskVQVAETrainStep G + D step (the CPU
     tests' size) on the card against the CPU, fp32 with TF32 off (ids and
     codebook hits equal; metrics, gradients and params after Adam within
     the limits `tokenizer_reference` states); then the ch-160 MaskVQVAE
     (z 32, 256x256, fp32) with random LPIPS and PatchGAN weights, lr
     1e-4, the GAN terms gated: one warm-up and three
     timed G then D steps on one repeated synthetic image/mask batch of 8
     (s/step, peak memory; every loss finite, usage_pct in (0, 100], the
     nll falling at every timed step and after the last one: the warm-up
     step's first Adam update lifts it), the DualGANTrainState through
     CheckpointIO bit for bit, and one VQVAETrainStep G + D step with
     every term (disc_start 0);
 19. the separator joint path: StepwiseJointSampler on that config (AdaLN
     gates raised) at B=8, stacked cache: a warm-up and a timed call (K1
     160, K2 10), then two greedy calls with equal ids and canvases, every
     id in [0, 4096);
 20. bidirectional training: ControlVAR-d16 bidirectional (class SOS,
     mask_factor 2) on a Loader batch: the two orders' losses at the same
     params differ; one pixel step with mask_first=True and one with False,
     both finite (K3/K4 32/16 each);
 21. ControlVARModel.sample_cond_cfg against StepwiseCondSampler: d16
     multi_cond, gates raised, B=16, force="control", greedy, repeat_num 4
     and 3: every draw's ids and both f_hats bit-equal (K1 160, K2 10 a
     call);
 22. shared_aln: VAR-d16 with shared_aln, StepwiseVARSampler at B=16 (gates
     raised; K1 160, K2 10 a call) and VARTrainStep at B=8 (K3/K4 32/16);
 23. the command line, `controlvar_tpu_torch.cli.main.main` called in this
     process on .pth files of a d16 multi_cond model (gates raised) and the
     ch-160 VQVAE written under .chip_scratch/, every count set to 0 just
     before each call and read just after: eval-cond --force control over
     two synthetic B=16 batches (K1 320, K2 20; its 32 PNGs, decoded here
     with zlib, bit-equal to _to_uint8 of direct
     SamplingHarness.control_conditioned calls on the same batches with
     generator_for(seed + bi); img/s of the CLI's loop and of the bare
     calls, and the PNG encode's share of the loop), eval-cond --force
     image (K1 160), sample joint (K1 160, K2 10), --kv_window 2 (K1 16,
     K5 144) and --sampler sort (K2 0), fid over two classes of 16 as one
     shard and as two (the same files, bit for bit), train --steps 3 (K3/K4
     96/48) -> export --ckpt_dir (the re-imported .pth equal to the
     checkpoint's params bit for bit), train-var --steps 2, train-vqvae
     --dual --steps 2 (B=8), and pretokenize (the synthetic split cut to 32
     samples, four shards) -> train --token_shards --steps 2;
 24. tensor parallelism at full d16 width over model=2: the one-device
     north-star call (gates raised) and train step recorded here, then two
     ranks of this script (`--tp-rank`) on this one card in a gloo group
     (NCCL refuses two ranks on one device), each with make_mesh(model=2)
     and its shard of the same params: a warm-up and a timed north-star
     call (B=16, every count set to 0 just before it: K1 160, K2 10 a rank;
     the ranks' generators seeded apart, their ids equal: model rank 0's
     draw, broadcast), a call on the one-device run's ids whose combined
     logits at scales 1 and 9 agree with that run's (TP_LOGIT_REL_L2), one
     train step (K3/K4 32/16 a rank; loss, grad_norm, gradient cosines and
     the gathered params after it against the one-device step) and two
     timed ones, then `cli.main train --model_axis 2` for one step (K3/K4
     32/16) on a second group. Its img/s and s/step are those of two ranks
     sharing one card over gloo: a correctness run, not TP speed;
 25. the Trainer's other model-axis modes, two more ranks of this script
     (`--tp-modes-rank`) on this card in a gloo group with make_mesh(model=2),
     rank 0 also running each one-device reference (in a group of its own,
     so that its steps average over one rank), every count set to 0 just
     before each path and read just after on both: ControlVAR-d16 with
     separator, type_pos, shared_aln and bidirectional (gates raised):
     StepwiseJointSampler at B=8 with the ranks' generators seeded apart
     (their ids equal; K1 160, K2 10), and a call on the one-device call's
     ids whose CFG branches' logits at scales 1 and 9 agree with that
     call's (TP_LOGIT_REL_L2 on each branch); a train step in each stream
     order and a from-tokens step with grad_accum 2 (K3/K4 32/16 and 64/32)
     against the one-device steps at phase 24's limits; StepwiseCondSampler
     on a shared_aln and bidirectional d16 (B=8) on the one-device ids; a
     LoRA r16 step over the cut d16 multi_cond base with random B (every
     factor's gradient cosine, both ranks' factors bit-equal); then `cli.main
     train --model_axis 2 --lora 16 --separator --type_pos --bidirectional
     --steps 1` (K3/K4 32/16) on a second group;
 26. the d30 paths: ControlVAR-d30 multi_cond (cos_attn, 30 heads of 64, C
     1920, 2.0 B params) at configs/train_imagenetc_d30.yaml's recipe
     (d30_recipe), the card freed between the parts: (a) K1 at every
     scale of the conditional (64 CFG rows) and joint (16 rows) paths'
     stacked caches and K3/K4 at (8, 30, 1360, 64), block-causal and
     strided, on cos_attn inputs (q and k L2-normalised, q times exp(min(s,
     log 100)) per head, s uniform in [0, log 200]: scores up to +-100),
     scale 1, at the d16 checks' limits, with their, the plain versions'
     and SDPA's times and bounds at the final scale and the training
     shape, and the same at a model=2 rank's shapes (15 of the 30 heads:
     K1 at the joint path's final scale (16, 15, 512, 64), K3/K4 at (8,
     15, 1360, 64)); (b) a tiny cos_attn bf16 decode step through K1 and train step
     through K3/K4 against the fp32 CPU, scale_mul drawn as in (a) and the
     gates raised; (c) ControlVARTrainStep with the ch-160 VQVAE inside,
     B=8 pixel batches, remat full (BASELINE config 5): init_params's host
     seconds and host memory, one warm-up and three timed steps (K3 60, K4
     30 a step), s/step, peak allocated and reserved memory; (d)
     SamplingHarness.control_conditioned on 16 seeded control images and
     (e) SamplingHarness.joint at B=8, each a warm-up and a timed call (K1
     300, K2 10), img/s and peak memory; (f) `cli.main train` with
     D30_TRAIN_FLAGS and --steps 2 (K3/K4 120/60, two finite logged
     losses);
 27. the parity tooling: eval/parity.py and `cli.main parity` on .pth
     files that the port's exporter writes from seeds, against a stub of
     the upstream checkout's `models` package (PARITY_STUB: the port's own
     modules on the CPU in fp32; the card's machine has neither the
     checkout nor the released weights), every count 0 before and after
     (the parity path runs no kernel): the ch-160 VQVAE's token streams of
     4 seeded 256x256 images at the 10 scales, bitwise, and the d16
     multi_cond model's (gates raised) teacher-forced logits at B=2 with
     use_flash=False on the card, within 5e-3 with every argmax equal;
     then `parity --depth 16 --ckpt --out` through the CLI, its report the
     direct call's;
 28. ControlVAR-d30 over model=2: the one-device joint call (B=8) and train
     step (the d30 recipe, B=8 pixel batches) here on init_params(0) with
     the gates raised, this process's d30 tree then freed; two ranks of
     this script (`--d30-tp-rank`) on this card in a gloo group, 15 heads
     each (the MLP, ada_lin and head cut): a joint call with the ranks'
     generators seeded apart (K1 300, K2 10 a rank; their ids equal), one
     on the one-device call's ids whose CFG branches' logits at scales 1
     and 9 agree with that call's (TP_LOGIT_REL_L2), and one train step
     (K3/K4 60/30 a rank) held at phase 24's limits on the loss, grad_norm
     and the gathered params and gradients of layers 0 and 29 and of every
     leaf outside the blocks;
 29. the blocks' AdaLN kernels (`ops/adaln.py`, csrc/adaln.cu) at every
     scale's tokens (one stream and two) at 4 and 64 rows, C 1024 and 1920,
     bf16 and fp32, each within one rounding of a float64 formula and within
     the sum of its and the plain chain's bounds of the chain; each kernel's,
     its plain version's and its bound's ms at the serving path's final
     scale (64 rows x 512 tokens); the three kernels' device time over one
     layer of a call's ten scales (CUDA graphs) beside its bound. (The
     serving path, phase 13, holds each kernel to depth x scales launches a
     call; the training phases hold each site to 2 x depth forward and
     depth backward launches a step, under remat full, dots and dots_attn.)
 30. VAR-d36 at 512x512 (FoundationVision/VAR --depth=36 --saln=1 --pn=512:
     C 2304, 36 heads, cos_attn, shared AdaLN, V 4096, the 2,240-token
     pyramid), 32 CFG rows: K1 at every scale (l up to 1024, cur up to
     2,240) on cos_attn inputs, the AdaLN kernels at C 2304 over every
     scale's tokens at 32 rows in bf16 and fp32, K2 at every scale's 16 pn^2
     rows of V 4096, each against its plain version and timed at the final
     scale; then SamplingHarness.class_conditional at B=16 (512x512 images),
     with K1, K2 and the AdaLN kernels held to depth x scales (K2: scales)
     launches a call, and those counts in the `kernels` line's d36 and
     C2304 entries.
 31. the AdaLN sites' backward kernels (A4-A6, csrc/adaln.cu) at the d30
     train step's (8, 1360, 1920) bf16 with drop path, each against its
     plain backward in float64 and bit-equal across two launches; each
     kernel's, its plain backward's and its byte bound's ms; one layer's
     three sites forward, recompute and backward (as remat full runs them)
     through the eager chains under autograd and through the Functions.
Prints the card, a `kernels` JSON line (K1-K8, the AdaLN kernels forward and
backward) and, last,
{"ok": true, "device": ...}.
It exits non-zero, printing no result, without CUDA or outside a checkout.
--profile adds, for each path (and each joint and VAR cache mode), the device busy
time, the idle share and kernel time by category from torch.profiler over
one more step or call (and host-clock phases of the serving call); the
kernel tables go to chiprun_out/chip_smoke_profile_<path>.txt.
"""
from __future__ import annotations

import contextlib
import functools
import glob
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor cores
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
PEAK_INT32_OPS = 16.7e12   # H100 SXM int32: 132 SMs x 64 INT32 lanes x 1.98 GHz
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# The attention kernels' limits (K1, K3-K8). Per element,
# |got - want| <= 2^-7 (|want| + mag), mag = sum_j |x_j| |y_j| over the
# terms of the product that goes through a bf16 rounding on both sides: p.V
# for K1, K3, K5-K8 and K4's dv (mag = the plain version on |V|, or |P|^T
# |dO|), and dS.K and dS^T.q for K4's dq and dk (mag = scale |dS| |K|,
# scale |dS|^T |q|). Both sides round p (or dS) to bf16 (rel. err <= 2^-9
# each) from fp32 values that differ in their last bits (K1/K3 round p
# unnormalised, the plain version normalised; K5/K6 and their plain
# versions both round p unnormalised, but relative to the running max of
# the tiles streamed so far and to the joint max of all scores), which
# moves an output by up to 2^-8 mag where terms
# cancel; the bf16 output and the fp32 sums add up to ~3 * 2^-9 |want|. The
# limit is twice that worst case. Over a whole output, ||got - want|| <=
# 2^-6 ||want||, which a dropped or misplaced tile breaks. K4 adds a floor of
# 2^-16 max(mag): where exact arithmetic gives dS = 0 (a query row that
# attends only to itself has P = 1 and dP = D), both sides keep the fp32
# rounding of dP - D, ~2^-20 of its terms, which no relative limit covers. Readings on an
# H100 at 700 W for K1: the largest err/limit is 0.70 (1.56e-2 at cur=2,
# where few terms of magnitude ~3 cancel) and 0.28 at the final scale
# (3.9e-3); the relative L2 error is 2.7e-3 to 3.1e-3 at every scale.
ATTN_RTOL = 2.0 ** -7
ATTN_REL_L2 = 2.0 ** -6
# K3's LSE, fp32 on both sides: m + log(l) with l summed in another order
# (and __expf against expf) over at most 1360 terms of at most 1, so the
# difference is a few fp32 ulps of l's relative error, far below 2^-13.
K3_LSE_ATOL = 2.0 ** -13
# The tiny-config train step, bf16 on the card against fp32 on the CPU: the
# loss within one bf16 rounding (2^-8 relative; the CPU's own bf16 step
# reads 1.1e-5), and the flattened gradients at a cosine >= 0.999 (bf16
# rounding noise of ~2^-8 per element gives 1 - 2^-17). The head and
# embedding leaves dominate that cosine (the block leaves' gradients are
# ~1e-6 of its norm at this init), so each gradient leaf of the blocks, which
# the attention kernels feed, is also held to a cosine >= 0.999: the CPU's
# own bf16 step reads 0.99998 at the worst leaf (q_bias), 50x inside it.
TRAIN_LOSS_RTOL = 2.0 ** -8
TRAIN_GRAD_COS = 0.999
TRAIN_BLOCK_LEAF_COS = 0.999
# COS_BF16_FLOOR. Under cos_attn with scale_mul up to the clamp (q of norm up
# to 100, scale 1) and the gates raised, bf16 arithmetic alone misses the two
# cosine limits above: the tiny step's own bf16 run on the CPU reads a whole-
# gradient cosine of 0.978 and 0.950 at its worst block leaf (q_bias) against
# fp32 (0.99998 with scale_mul at its init, log 4; 0.9999 at log 20). A score
# of magnitude up to 100 moves by ~0.05 when q and k round to bf16, which
# moves a softmax weight by ~5%. So that step is held against the CPU's own
# bf16 step's cosines, measured in the same run (_check_train_step).
# configs/train_imagenetc_d30.yaml as `cli.main train` flags (the card's
# machine has no pyyaml), synthetic data in place of ImageNet-C; the
# recipe's pretrained VAR is not in the repository. tests/test_torch_d30.py
# holds these flags and d30_recipe() to the YAML through both CLIs.
D30_TRAIN_FLAGS = ("--depth", "30", "--multi_cond", "--drop_path_rate", "0.1", "--lr", "4e-5",
                   "--wd", "0.08", "--wd_end", "0.08", "--schedule", "lin0", "--batch_size",
                   "8", "--data", "synthetic")
COS_SCALE_MAX = 200.0   # scale_mul drawn in [0, log 200]; the model clamps at log 100
TINY_COS_SEED = 5       # its (2, 2) scale_mul: one head clamped, three not


def d30_recipe():
    """The d30 recipe's model config and OptimConfig (BASELINE config 5)."""
    from controlvar_tpu_torch.config import OptimConfig, control_var_config_from_depth

    return (control_var_config_from_depth(30, multi_cond=True, drop_path_rate=0.1),
            OptimConfig(base_lr=4e-5, total_batch_size=8, weight_decay=0.08,
                        weight_decay_end=0.08, schedule="lin0"))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over `reps` back-to-back calls, after a warm-up."""
    from controlvar_tpu_torch.probes.decode_scales import events_ms

    return events_ms(fn, reps)


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_close(name, got, want, mag, floor: float = 0.0) -> float:
    """An attention kernel's output against its plain version within the
    limits above; `mag` is the sum of the magnitudes of the rounded
    product's terms, `floor` an absolute floor of the per-element limit.
    Returns the largest absolute error."""
    import torch

    got, want, mag = got.float(), want.float(), mag.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite output")
    err = (got - want).abs()
    limit = ATTN_RTOL * (want.abs() + mag) + floor
    bad = int((err > limit).sum())
    max_err, worst = float(err.max()), float((err / limit).max())
    rel_l2 = float(err.norm() / want.norm())
    print(f"{name}: max_abs_err={max_err:.3e} largest err/limit={worst:.3f} "
          f"outside the limit={bad} rel_l2={rel_l2:.3e}")
    if bad:
        fail(f"{name}: {bad} elements outside {ATTN_RTOL:g} (|want| + mag)")
    if rel_l2 > ATTN_REL_L2:
        fail(f"{name}: relative L2 error {rel_l2:.3e} > {ATTN_REL_L2:g}")
    return max_err


def tv_check(name, row, ids, kept) -> None:
    """Draws `ids` of one tiled logits row against the analytic softmax over
    the kept set: every draw is kept, and the empirical total-variation
    distance is within 2x of the multinomial noise, E[TV] <= 0.5 sum
    sqrt(p(1-p)/n), plus 1e-3, as the CPU test of the sampler holds it."""
    import numpy as np

    r, k, d = (t.cpu().numpy() for t in (row.double(), kept, ids))
    e = np.where(k, np.exp(r - r.max()), 0.0)
    p, n = e / e.sum(), d.size
    if not k[d].all():
        fail(f"{name}: a draw lies outside the kept set")
    tv = 0.5 * np.abs(np.bincount(d, minlength=r.size) / n - p).sum()
    noise = 0.5 * np.sqrt(p * (1 - p) / n).sum()
    print(f"{name}: {n} draws over {int(k.sum())} kept ids, TV {tv:.4f} "
          f"(limit {2 * noise + 1e-3:.4f})")
    if tv >= 2.0 * noise + 1e-3:
        fail(f"{name}: TV {tv:.4f} beyond the multinomial noise {noise:.4f}")


def scale_times(name, cases, depth, call) -> None:
    """A decode kernel's and SDPA's device times at every scale of a path,
    and their sums over one call (each scale's time times the depth).
    cases yields (label, kernel fn, SDPA fn), one scale at a time; each time
    is graph_ms's (CUDA graphs, so host dispatch does not enter it)."""
    from controlvar_tpu_torch.probes.decode_scales import graph_ms

    per_scale = []
    for label, kernel, sdpa in cases:
        per_scale.append((graph_ms(kernel), graph_ms(sdpa)))
        print(f"{name} per scale, {label}: kernel {per_scale[-1][0]:.4f} ms, "
              f"sdpa {per_scale[-1][1]:.4f} ms (device time, CUDA graph)")
    per_call = [depth * sum(col) for col in zip(*per_scale)]
    print(f"{name} per {call} ({depth} layers x {len(per_scale)} scales): kernel "
          f"{per_call[0]:.4f} ms, sdpa {per_call[1]:.4f} ms")


def _k1_times(torch, label, q, ck, cv, li, cur, scale):
    """K1's, its plain version's and SDPA's times on q (R, H, l, hd) over
    rows [0, cur) of layer li of the stacked cache, unmasked, with the
    bound; the kernels-line numbers."""
    import torch.nn.functional as F

    from controlvar_tpu_torch.ops.attention import decode_attention, decode_attention_plain

    R, H, l, hd = q.shape
    kk, vv = ck[li, :, :, :cur], cv[li, :, :, :cur]
    ms = cuda_ms(lambda: decode_attention(q, ck, cv, li, cur, scale), 20)
    plain_ms = cuda_ms(lambda: decode_attention_plain(q, kk, vv, scale), 5)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, kk, vv, scale=scale), 20)
    nbytes = 2 * (2 * q.numel() + 2 * R * H * cur * hd)   # q, out, K, V in bf16
    b_ms, b_by = bound_ms(nbytes, 4 * R * H * l * cur * hd, PEAK_BF16_FLOPS)
    print(f"K1 {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def k1_phase(torch, cfg, cfg24, sep_cfg):
    """Decode attention vs its plain version; returns the kernels-line entry."""
    import torch.nn.functional as F

    from controlvar_tpu_torch.models.masks import attn_mask_for_config
    from controlvar_tpu_torch.ops.attention import decode_attention, decode_attention_plain

    g = torch.Generator(device="cuda").manual_seed(1)
    dev, bf = "cuda", torch.bfloat16
    R_B, H, hd, L = 64, cfg.num_heads, cfg.head_dim, cfg.seq_len
    scale = cfg.attn_scale
    ck = torch.randn(2, R_B, H, L, hd, generator=g, device=dev).to(bf)
    cv = torch.randn(2, R_B, H, L, hd, generator=g, device=dev).to(bf)

    def rand_q(l, B=R_B, H=H):
        """q of std 4 (scores of std ~1 after the 1/32 scale, a peaked
        softmax), the strided (B, H, l, hd) view of a fused QKV output, as
        the blocks give it."""
        qkv = (4 * torch.randn(B, l, 3, H, hd, generator=g, device=dev)).to(bf)
        return qkv.permute(2, 0, 3, 1, 4)[0]

    def case(name, q, ck, cv, li, cur, mask=None):
        got = decode_attention(q, ck, cv, li, cur, scale, mask)
        kk, vv = ck[li, :, :, :cur], cv[li, :, :, :cur]
        want = decode_attention_plain(q, kk, vv, scale, mask)
        mag = decode_attention_plain(q, kk, vv.abs(), scale, mask)
        return check_close(name, got, want, mag)

    errs = []
    # every scale's (l, cur) of the serving path, over layer 1 of the cache
    for lo, cur in cfg.begin_ends:
        errs.append(case(f"K1 l={cur - lo} cur={cur}", rand_q(cur - lo), ck, cv, 1, cur))
    # masked: separate_decoding + indep mask rows of the final scale
    from controlvar_tpu_torch.config import control_var_config_from_depth

    mcfg = control_var_config_from_depth(16, multi_cond=True, separate_decoding=True,
                                         indep=True)
    lo, hi = mcfg.begin_ends[-1]
    mask = torch.from_numpy(attn_mask_for_config(mcfg)[lo:hi, :hi]).to(dev)
    if bool(mask.all()):
        fail("K1 masked case: the mask slice masks nothing")
    errs.append(case(f"K1 masked l={hi - lo} cur={hi}", rand_q(hi - lo), ck, cv, 0, hi, mask))
    # every scale of the d24 joint path's stacked cache: 16 CFG rows x 24
    # heads, 384 heads, so the items do not fill the persistent grid evenly
    H24 = cfg24.num_heads
    ck24, cv24 = (torch.randn(2, 16, H24, cfg24.seq_len, hd, generator=g, device=dev).to(bf)
                  for _ in range(2))
    for si, (lo, cur) in enumerate(cfg24.begin_ends):
        errs.append(case(f"K1 d24 l={cur - lo} cur={cur}", rand_q(cur - lo, 16, H24), ck24,
                         cv24, si % 2, cur))
    del ck24, cv24
    # B * H = 70,000 > 65535: one item axis, no grid limit
    big_k, big_v = (torch.randn(2, 4375, 16, 72, hd, generator=g, device=dev).to(bf)
                    for _ in range(2))
    errs.append(case("K1 B*H=70000 l=8 cur=64", rand_q(8, 4375, 16), big_k, big_v, 1, 64))
    del big_k, big_v
    # every scale of the d16 separator joint path (16 CFG rows): l = 2 (pn^2 + 1)
    # after scale 0, the scale edges at 2, 12, 32, ... off the 64-row tiles
    cks, cvs = (torch.randn(2, 16, H, sep_cfg.seq_len, hd, generator=g, device=dev).to(bf)
                for _ in range(2))
    for si, (lo, cur) in enumerate(sep_cfg.begin_ends):
        errs.append(case(f"K1 d16 separator l={cur - lo} cur={cur}", rand_q(cur - lo, 16), cks,
                         cvs, si % 2, cur))

    def sep_cases():
        for lo, cur in sep_cfg.begin_ends:
            q = rand_q(cur - lo, 16)
            kc, vc = cks[1, :, :, :cur].contiguous(), cvs[1, :, :, :cur].contiguous()
            yield (f"l={cur - lo} cur={cur}",
                   lambda: decode_attention(q, cks, cvs, 1, cur, scale),
                   lambda: F.scaled_dot_product_attention(q, kc, vc, scale=scale))

    scale_times("K1 separator", sep_cases(), sep_cfg.depth, "d16 separator joint call")
    del cks, cvs

    # K1 and SDPA (over contiguous K/V made outside the time) at every scale
    def k1_cases():
        for lo, cur in cfg.begin_ends:
            q = rand_q(cur - lo)
            kc, vc = ck[1, :, :, :cur].contiguous(), cv[1, :, :, :cur].contiguous()
            yield (f"l={cur - lo} cur={cur}",
                   lambda: decode_attention(q, ck, cv, 1, cur, scale),
                   lambda: F.scaled_dot_product_attention(q, kc, vc, scale=scale))

    scale_times("K1", k1_cases(), cfg.depth, "serving call")

    def final_scale(label, ck, cv, heads):
        """K1's times at the serving path's final scale (l 512, cur 1360)."""
        return _k1_times(torch, label, rand_q(512, H=heads), ck, cv, 1, L, scale)

    full = final_scale("final scale", ck, cv, H)
    # a tensor-parallel rank's cache at model=2: 8 of the 16 heads
    Ht = H // 2
    ckt, cvt = ck[:, :, :Ht].contiguous(), cv[:, :, :Ht].contiguous()
    for lo, cur in cfg.begin_ends:
        errs.append(case(f"K1 tensor-parallel rank (8 heads) l={cur - lo} cur={cur}",
                         rand_q(cur - lo, H=Ht), ckt, cvt, 1, cur))
    tp_rank = final_scale("tensor-parallel rank (8 heads), final scale", ckt, cvt, Ht)
    del ckt, cvt
    # the separator joint path on a tensor-parallel rank (phase 25): 16 CFG
    # rows, 8 of the 16 heads, every scale up to cur 1378
    cks, cvs = (torch.randn(2, 16, Ht, sep_cfg.seq_len, hd, generator=g, device=dev).to(bf)
                for _ in range(2))
    for si, (lo, cur) in enumerate(sep_cfg.begin_ends):
        errs.append(case(f"K1 d16 separator tensor-parallel rank (8 heads) l={cur - lo} "
                         f"cur={cur}", rand_q(cur - lo, 16, Ht), cks, cvs, si % 2, cur))
    lo, cur = sep_cfg.begin_ends[-1]
    tp_sep = _k1_times(torch, f"d16 separator tensor-parallel rank (8 heads), final scale "
                       f"(16, 8, {cur - lo}, 64) over {cur} rows", rand_q(cur - lo, 16, Ht),
                       cks, cvs, 1, cur, scale)
    del cks, cvs
    return dict(name="decode_attention", route="cuda",
                source="controlvar_tpu_torch/csrc/decode_attention.cu",
                replaces="controlvar_tpu/ops/attention.py:403",
                max_abs_err=max(errs), tp_rank=tp_rank, tp_sep=tp_sep, **full)


def _k2_bound(n, V, n_kept):
    """K2's bound on n rows of V logits with n_kept kept logits. The
    function's work: one read of the logits and the ids written; per logit
    the max, the two filters' compares, and x - m and its exp (5 fp32
    operations); per kept logit Philox4x32-10 (10 rounds of 2 mul.hi, 2
    mul.lo, 4 xor and 2 adds: 100 int32 operations) and the draw (the
    uniform's convert and multiply-add, two logs, two negations and the add:
    7 fp32 operations). fp32 at 67 TFLOP/s; int32 at 132 SMs x 64 INT32
    lanes x 1.98 GHz = 16.7 TOPS."""
    t_ops = (5 * n * V + 7 * n_kept) / PEAK_FP32_FLOPS + 100 * n_kept / PEAK_INT32_OPS
    return bound_ms(4 * n * V + 8 * n, t_ops, 1.0)


def _k2_agree(name, l, nz, k, p, every_row):
    """ids of the kernel and of the plain version on the same noise: equal
    on every row (top-k alone: the kernel's threshold is the bisection's
    bit for bit), or on >= 0.999 of the rows (top-p: the kept mass is
    summed in another order, which may move the crossing); every draw in
    the plain kept set. Returns the share of rows that differ."""
    from controlvar_tpu_torch.ops.sample_kernel import (kept_mask_plain, sample_bisect_plain,
                                                        sample_top_k_top_p_bisect)

    ids_k = sample_top_k_top_p_bisect(l, k, p, noise=nz)
    ids_p = sample_bisect_plain(l, nz, k, p)
    share = float((ids_k == ids_p).float().mean())
    print(f"K2 {name} (top-k {k}, top-p {p}), {l.shape[0]}x{l.shape[1]}: ids equal on "
          f"{share * l.shape[0]:.0f}/{l.shape[0]} rows ({share:.6f})")
    if every_row and share < 1.0:
        fail(f"K2 {name}: ids differ from the plain version's on "
             f"{l.shape[0] - round(share * l.shape[0])} rows")
    if share < 0.999:
        fail(f"K2 {name}: ids agree on only {share:.6f} of {l.shape[0]} rows")
    if not bool(kept_mask_plain(l, k, p).gather(1, ids_k[:, None]).all()):
        fail(f"K2 {name}: a drawn id lies outside the plain kept set")
    return 1.0 - share


def k2_phase(torch, V, patch_nums):
    """Bisection sampling vs its plain version; returns the kernels-line entry."""
    from controlvar_tpu_torch.ops.sample_kernel import (
        gumbel_noise, kept_mask_plain, sample_bisect_plain, sample_top_k_top_p_bisect)
    from controlvar_tpu_torch.ops.sampling import sample_top_k_top_p
    from controlvar_tpu_torch.probes.decode_scales import graph_ms

    n, top_k, top_p = 16 * 3 * patch_nums[-1] ** 2, 900, 0.96
    g = torch.Generator(device="cuda").manual_seed(2)
    logits = 3.0 * torch.randn(n, V, generator=g, device="cuda")
    logits[:, :8] += 10.0  # a peaked head, as CFG logits have
    gen = lambda seed: torch.Generator().manual_seed(seed)

    noise = gumbel_noise((n, V), gen(3), "cuda")

    # the same noise to both, at every scale's row count (B * 3 * pn^2), with
    # top-k alone and with top-p
    mismatch = 0.0
    for pn in patch_nums:
        m = 16 * 3 * pn * pn
        _k2_agree(f"{pn}x{pn} scale", logits[:m], noise[:m], top_k, 0.0, True)
        mismatch = max(mismatch, _k2_agree(f"{pn}x{pn} scale", logits[:m], noise[:m], top_k,
                                       top_p, False))
    # ties (values on a grid of 1/4), V = 1000, top-k 0 with top-p, top-k >= V,
    # and flat rows (N(0, 0.01)), where a token more or less at the top-k
    # threshold is drawn often
    tied = torch.round(4.0 * logits[:4096]) / 4.0
    narrow = logits[:4096, :1000].contiguous()
    flat = 0.01 * torch.randn(4096, V, generator=g, device="cuda")
    for name, l, k, p, every_row in (("tied logits", tied, top_k, 0.0, True),
                                     ("flat logits", flat, 50, 0.0, True),
                                     ("flat logits", flat, 50, 0.5, False),
                                     ("tied logits", tied, top_k, top_p, False),
                                     ("V = 1000", narrow, top_k, 0.0, True),
                                     ("V = 1000", narrow, top_k, top_p, False),
                                     ("no top-k", logits[:4096], 0, top_p, False),
                                     ("top-k >= V", logits[:4096], V, 0.0, True),
                                     ("top-k >= V", logits[:4096], V + 100, top_p, False)):
        mismatch = max(mismatch, _k2_agree(name, l, noise[:l.shape[0], :l.shape[1]].contiguous(),
                                       k, p, every_row))

    greedy = sample_top_k_top_p_bisect(logits, 1, 0.0, generator=gen(4))
    if not torch.equal(greedy, logits.argmax(-1)):
        fail("K2: greedy draw differs from argmax")

    a = sample_top_k_top_p_bisect(logits, top_k, top_p, generator=gen(5))
    b = sample_top_k_top_p_bisect(logits, top_k, top_p, generator=gen(5))
    c = sample_top_k_top_p_bisect(logits, top_k, top_p, generator=gen(6))
    if not torch.equal(a, b):
        fail("K2 Philox: the same seed gave other ids")
    if torch.equal(a, c):
        fail("K2 Philox: two seeds gave the same ids")
    kept = kept_mask_plain(logits, top_k, top_p)
    if not bool(kept.gather(1, a[:, None]).all()):
        fail("K2 Philox: a drawn id lies outside the plain kept set")
    print(f"K2: greedy == argmax, Philox draws deterministic per seed, all in "
          f"the kept set (mean kept {float(kept.sum(-1).float().mean()):.1f} ids/row)")

    # the Philox draws' distribution: 1e4 copies of a broad row (N(0, 1), some
    # hundreds kept) and of a peaked row of the logits above
    n_draw = 10_000
    broad = torch.randn(V, generator=g, device="cuda")
    for rname, row in (("broad", broad), ("peaked", logits[0])):
        ids = sample_top_k_top_p_bisect(row.expand(n_draw, V), top_k, top_p,
                                        generator=gen(8))
        tv_check(f"K2 Philox, {rname} row", row, ids,
                 kept_mask_plain(row[None], top_k, top_p)[0])
    # the unfiltered categorical makes its noise on the card
    ids = sample_top_k_top_p(broad.expand(n_draw, V), 0, 0.0, gen(9))
    if not torch.equal(ids, sample_top_k_top_p(broad.expand(n_draw, V), 0, 0.0, gen(9))):
        fail("unfiltered categorical: the same seed gave other ids")
    tv_check("unfiltered categorical, broad row", broad, ids,
             torch.ones(V, dtype=torch.bool, device="cuda"))

    # device time at every scale's row count (Philox, as the path calls it;
    # CUDA graphs, since host dispatch exceeds the small scales' launches)
    per_scale = [graph_ms(lambda: sample_top_k_top_p_bisect(logits[:16 * 3 * pn * pn], top_k,
                                                              top_p, generator=gen(7)))
                 for pn in patch_nums]
    print("K2 per scale (rows: ms): " + ", ".join(
        f"{16 * 3 * pn * pn}: {t:.4f}" for pn, t in zip(patch_nums, per_scale))
          + f"; one call's 10 launches {sum(per_scale):.4f} ms")
    ms = cuda_ms(lambda: sample_top_k_top_p_bisect(logits, top_k, top_p, generator=gen(7)), 20)
    plain_ms = cuda_ms(lambda: sample_bisect_plain(logits, noise, top_k, top_p), 3)
    n_kept = float(kept.sum())
    b_ms, b_by = _k2_bound(n, V, n_kept)
    print(f"K2 final scale ({n}x{V}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}; {n_kept:.0f} kept logits)")
    return dict(name="sample_top_k_top_p_bisect", route="cuda",
                source="controlvar_tpu_torch/csrc/sample_bisect.cu",
                replaces="controlvar_tpu/ops/sample_kernel.py:126",
                # ids, not values: the largest share of rows whose drawn id differs
                max_abs_err=mismatch,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def _bwd_mags(torch, q, k, v, mask, out, lse, do, scale):
    """The magnitudes K4's limits scale with: (scale |dS| |K|, scale |dS|^T
    |q|, |P|^T |dO|), from the plain version's fp32 P and dS."""
    from controlvar_tpu_torch.ops.attention import _scores

    p = torch.exp(_scores(q, k, mask, scale) - lse[..., None])
    d = (do.float() * out.float()).sum(-1, keepdim=True)
    ds = (p * (do.float() @ v.float().transpose(-1, -2) - d)).abs()
    return (scale * ds @ k.float().abs(), scale * ds.transpose(-1, -2) @ q.float().abs(),
            p.transpose(-1, -2) @ do.float().abs())


def _check_k3(torch, name, q, k, v, mask, sc, out, lse):
    """K3's out and lse against the plain version's, and a second run on
    the same inputs bit-equal to the first; returns out's largest error."""
    from controlvar_tpu_torch.ops.attention import flash_attention, flash_attention_plain

    want, want_lse = flash_attention_plain(q, k, v, mask, sc)
    mag = flash_attention_plain(q, k, v.abs(), mask, sc)[0]
    err = check_close(f"K3 {name}: out", out, want, mag)
    lse_err = float((lse - want_lse).abs().max())
    print(f"K3 {name}: lse max_abs_err={lse_err:.3e}")
    if not lse_err <= K3_LSE_ATOL:
        fail(f"K3 {name}: lse error {lse_err:.3e} > {K3_LSE_ATOL:g}")
    again, again_lse = flash_attention(q, k, v, mask, sc)
    if not (torch.equal(out, again) and torch.equal(lse, again_lse)):
        fail(f"K3 {name}: out or lse differs between two runs on the same inputs")
    print(f"K3 {name}: out, lse bit-equal over two runs")
    return err


def _check_k4(torch, name, q, k, v, do, mask, scale):
    """K4 against its plain version from the plain forward's out and lse
    (so only K4 differs), and a second run bit-equal to the first; returns
    the largest errors of dq, dk and dv."""
    from controlvar_tpu_torch.ops.attention import (flash_attention_bwd,
                                                    flash_attention_bwd_plain,
                                                    flash_attention_plain)

    want, want_lse = flash_attention_plain(q, k, v, mask, scale)
    got = flash_attention_bwd(q, k, v, mask, want, want_lse, do, scale)
    ref = flash_attention_bwd_plain(q, k, v, mask, want, want_lse, do, scale)
    mags = _bwd_mags(torch, q, k, v, mask, want, want_lse, do, scale)
    errs = [check_close(f"K4 {name}: {gname}", a, b, m, 2.0 ** -16 * float(m.max()))
            for gname, a, b, m in zip(("dq", "dk", "dv"), got, ref, mags)]
    del mags
    # no atomics: a second run on the same inputs gives the same bits
    again = flash_attention_bwd(q, k, v, mask, want, want_lse, do, scale)
    for gname, a, b in zip(("dq", "dk", "dv"), got, again):
        if not torch.equal(a, b):
            fail(f"K4 {name}: {gname} differs between two runs on the same inputs")
    print(f"K4 {name}: dq, dk, dv bit-equal over two runs")
    return errs


def _flash_times(torch, label, q, k, v, do, mask, scale):
    """K3's and K4's times at a training path's shape, strides and
    precomputed flags, beside their plain versions', SDPA's and their
    bounds."""
    import torch.nn.functional as F

    from controlvar_tpu_torch.ops.attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain, tile_flags)

    B, H, L, hd = q.shape
    flags = tile_flags(mask)
    out, lse = flash_attention(q, k, v, mask, scale, flags)
    ms3 = cuda_ms(lambda: flash_attention(q, k, v, mask, scale, flags), 20)
    plain3 = cuda_ms(lambda: flash_attention_plain(q, k, v, mask, scale), 3)
    lib3 = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                          scale=scale), 20)
    ms4 = cuda_ms(lambda: flash_attention_bwd(q, k, v, mask, out, lse, do, scale, flags), 20)
    plain4 = cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, mask, out, lse, do, scale), 3)
    qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask, scale=scale)
    lib4 = cuda_ms(lambda: torch.autograd.grad(o_lib, (qq, kk, vv), do, retain_graph=True),
                   20)
    n = B * H * L * hd
    # the work the function needs: the mask's unmasked scores only (about
    # 62% of L x L at these shapes), 2 matmul FLOP per score and hd for each
    # product, 2 products in the forward (QK^T, PV) and 5 in the backward
    # (S, dP, dV, dQ, dK)
    per_score = B * H * hd * int(mask.sum())
    b3 = bound_ms(2 * 4 * n + 4 * B * H * L + L * L, 4 * per_score, PEAK_BF16_FLOPS)
    b4 = bound_ms(2 * 8 * n + 4 * B * H * L + L * L, 10 * per_score, PEAK_BF16_FLOPS)
    print(f"K3 {label}: kernel {ms3:.4f} ms, plain {plain3:.4f} ms, "
          f"sdpa {lib3:.4f} ms, bound {b3[0]:.4f} ms ({b3[1]})")
    print(f"K4 {label}: kernel {ms4:.4f} ms, plain {plain4:.4f} ms, "
          f"sdpa backward {lib4:.4f} ms, bound {b4[0]:.4f} ms ({b4[1]})")
    return (ms3, plain3, lib3, b3), (ms4, plain4, lib4, b4)


def flash_phase(torch, cfg, var_cfg, sep_cfg):
    """K3 and K4 vs their plain versions at the d16 training shape, at the
    VAR-d16 one (L = 680: a 40-row last tile, the plain block-causal mask),
    at the d16 separator one (L = 1378: scale edges off the 64-row grid, a
    34-row last tile) and at a small ragged one; times at the three training
    shapes. Returns the two kernels-line entries (at the ControlVAR-d16
    shape)."""
    from controlvar_tpu_torch.models.masks import attn_mask_for_config
    from controlvar_tpu_torch.ops.attention import flash_attention, tile_flags

    g = torch.Generator(device="cuda").manual_seed(4)
    dev, bf, hd, scale = "cuda", torch.bfloat16, cfg.head_dim, cfg.attn_scale

    def inputs(B, H, L, strided):
        """q (std 4: scores of std ~1 after the 1/32 scale), k, v and dO.
        strided: q, k, v are the (B, H, L, hd) views of one (B, L, 3, H, hd)
        tensor and dO a transposed (B, L, H, hd) one, as the training path's
        fused QKV and its output projection give them."""
        if not strided:
            rand = lambda std: (std * torch.randn(B, H, L, hd, generator=g, device=dev)).to(bf)
            return rand(4.0), rand(1.0), rand(1.0), rand(1.0)
        qkv = torch.randn(B, L, 3, H, hd, generator=g, device=dev)
        qkv[:, :, 0] *= 4.0
        q, k, v = qkv.to(bf).permute(2, 0, 3, 1, 4)
        do = torch.randn(B, L, H, hd, generator=g, device=dev).to(bf).transpose(1, 2)
        return q, k, v, do

    def tile_pattern_mask(L):
        """A random pattern of 64 x 64 tiles, about half of them fully
        masked, a quarter mixed and a quarter full, with the diagonal kept
        so that every row attends somewhere: its fully masked tiles lie
        anywhere, not in one contiguous run as the block-causal mask's do."""
        nt = -(-L // 64)
        kind = torch.randint(0, 4, (nt, nt), generator=g, device=dev)  # 0, 1 empty; 2 mixed
        kind = kind.repeat_interleave(64, 0).repeat_interleave(64, 1)[:L, :L]
        mask = (kind == 3) | ((kind == 2) & (torch.rand(L, L, generator=g, device=dev) > 0.5))
        mask.diagonal().fill_(True)
        flags = tile_flags(mask)
        print(f"tile-pattern mask: tiles fully masked / mixed / full = "
              f"{int((flags == 2).sum())} / {int((flags == 0).sum())} / "
              f"{int((flags == 1).sum())}")
        return mask

    train_mask = torch.from_numpy(attn_mask_for_config(cfg)).to(dev)
    var_mask = torch.from_numpy(attn_mask_for_config(var_cfg)).to(dev)
    sep_mask = torch.from_numpy(attn_mask_for_config(sep_cfg)).to(dev)
    cases = [("d16 train (8, 16, 1360, 64), block-causal, strided", 8, cfg.num_heads,
              train_mask, True),
             ("VAR-d16 train (8, 16, 680, 64), block-causal, strided", 8, var_cfg.num_heads,
              var_mask, True),
             ("d16 separator train (8, 16, 1378, 64), block-causal, strided", 8,
              sep_cfg.num_heads, sep_mask, True),
             ("ragged (2, 3, 100, 64), causal", 2, 3,
              torch.ones(100, 100, dtype=torch.bool, device=dev).tril(), False),
             ("random 64x64 tile pattern (8, 16, 1360, 64), strided", 8, cfg.num_heads,
              tile_pattern_mask(cfg.seq_len), True),
             ("d16 tensor-parallel rank (8, 8, 1360, 64), block-causal, strided", 8,
              cfg.num_heads // 2, train_mask, True),
             ("d16 separator tensor-parallel rank (8, 8, 1378, 64), block-causal, strided", 8,
              sep_cfg.num_heads // 2, sep_mask, True)]

    errs3, errs4 = [], []
    for name, B, H, mask, strided in cases:
        q, k, v, do = inputs(B, H, mask.shape[0], strided)
        out, lse = flash_attention(q, k, v, mask, scale)
        errs3.append(_check_k3(torch, name, q, k, v, mask, scale, out, lse))
        errs4 += _check_k4(torch, name, q, k, v, do, mask, scale)

    # K3 alone: rows that attend nowhere (the TPU kernel's P = 1 on every
    # key; their tiles are never skipped), and a scale that is not a power of
    # two (q*scale is rounded to bf16 in the kernel)
    B, H, L = 8, cfg.num_heads, cfg.seq_len
    nowhere = train_mask.clone()
    nowhere[[0, 70, 700, 1359]] = False
    for name, mask, sc in (("d16 train, rows 0, 70, 700, 1359 attend nowhere", nowhere, scale),
                           ("d16 train, block-causal, scale 0.9/32", train_mask, 0.9 / 32)):
        q, k, v, _ = inputs(B, H, L, True)
        out, lse = flash_attention(q, k, v, mask, sc)
        errs3.append(_check_k3(torch, name, q, k, v, mask, sc, out, lse))

    def times(label, B, H, mask):
        return _flash_times(torch, label, *inputs(B, H, mask.shape[0], True), mask, scale)

    (ms3, plain3, lib3, b3), (ms4, plain4, lib4, b4) = times("d16 train shape", B, H, train_mask)
    times("VAR-d16 train shape (8, 16, 680, 64)", 8, var_cfg.num_heads, var_mask)
    times("d16 separator train shape (8, 16, 1378, 64)", 8, sep_cfg.num_heads, sep_mask)
    tp3, tp4 = times("d16 tensor-parallel rank shape (8, 8, 1360, 64)", 8, H // 2, train_mask)
    sep3, sep4 = times("d16 separator tensor-parallel rank shape (8, 8, 1378, 64)", 8,
                       sep_cfg.num_heads // 2, sep_mask)
    tp_rank = lambda ms, plain, lib, b: dict(ms=ms, plain_ms=plain, library_ms=lib,
                                             bound_ms=b[0], bound_by=b[1])
    return (dict(name="flash_attention", route="cuda",
                 source="controlvar_tpu_torch/csrc/flash_attention.cu",
                 replaces="controlvar_tpu/ops/attention.py:99", max_abs_err=max(errs3),
                 ms=ms3, plain_ms=plain3, bound_ms=b3[0], bound_by=b3[1], library_ms=lib3,
                 tp_rank=tp_rank(*tp3), tp_sep=tp_rank(*sep3)),
            dict(name="flash_attention_bwd", route="cuda",
                 source="controlvar_tpu_torch/csrc/flash_attention.cu",
                 replaces="controlvar_tpu/ops/attention.py:1085", max_abs_err=max(errs4),
                 ms=ms4, plain_ms=plain4, bound_ms=b4[0], bound_by=b4[1], library_ms=lib4,
                 tp_rank=tp_rank(*tp4), tp_sep=tp_rank(*sep4)))


def prefix_phase(torch, cfg):
    """K5 and K6 vs their plain versions at the d24 joint path's shapes and
    at small ragged masked ones; times at every scale and at the final one.
    Returns the two kernels-line entries (K5's at the kv_window=2 shape its
    path runs)."""
    import torch.nn.functional as F

    from controlvar_tpu_torch.config import control_var_config_from_depth
    from controlvar_tpu_torch.models.masks import attn_mask_for_config
    from controlvar_tpu_torch.ops.attention import (
        decode_attention_inplace, decode_attention_inplace_plain, decode_attention_prefix,
        decode_attention_prefix_plain)
    from controlvar_tpu_torch.probes.decode_scales import seg_scales

    g = torch.Generator(device="cuda").manual_seed(7)
    dev, bf, hd, scale = "cuda", torch.bfloat16, cfg.head_dim, cfg.attn_scale
    R, H = 16, cfg.num_heads          # 2 CFG branches x B = 8, 24 heads
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev)

    def fresh(B, H, l):
        """q (std 4: scores of std ~1 after the 1/32 scale), k, v: the
        (B, H, l, hd) views of one (B, l, 3, H, hd) tensor, as the blocks'
        fused QKV gives them."""
        qkv = randn(B, l, 3, H, hd)
        qkv[:, :, 0] *= 4.0
        return qkv.to(bf).permute(2, 0, 3, 1, 4)

    def seg_views(B, H, pos, l):
        """K5's operands as blocks_decode_seg gives them: q strided from the
        fused QKV, the prefix as layer 1 of the (depth, B, H, pos, hd)
        concatenation of the kept segments, the fresh rows as layer 1 of
        this scale's (depth, B, H, l, hd) segment."""
        pre, seg = randn(2, 2, B, H, pos, hd).to(bf), randn(2, 2, B, H, l, hd).to(bf)
        return fresh(B, H, l)[0], pre[0, 1], pre[1, 1], seg[0, 1], seg[1, 1]

    def k5_case(name, q, pk, pv, kn, vn, mask=None):
        got = decode_attention_prefix(q, pk, pv, kn, vn, scale, mask)
        want = decode_attention_prefix_plain(q, pk, pv, kn, vn, scale, mask)
        mag = decode_attention_prefix_plain(q, pk, pv.abs(), kn, vn.abs(), scale, mask)
        return check_close(f"K5 {name}", got, want, mag)

    def k6_case(name, q, ck, cv, kn, vn, li, pos):
        cur = pos + q.shape[2]
        before_k, before_v = ck.clone(), cv.clone()
        got = decode_attention_inplace(q, ck, cv, kn, vn, li, pos, scale)
        torch.cuda.synchronize()
        pk, pv = before_k[li, :, :, :pos], before_v[li, :, :, :pos]
        want = decode_attention_prefix_plain(q, pk, pv, kn, vn, scale)
        mag = decode_attention_prefix_plain(q, pk, pv.abs(), kn, vn.abs(), scale)
        err = check_close(f"K6 {name}", got, want, mag)
        for cname, after, before, new in (("K", ck, before_k, kn), ("V", cv, before_v, vn)):
            before[li, :, :, pos:cur] = new
            if not torch.equal(after, before):
                fail(f"K6 {name}: the {cname} cache differs outside rows [{pos}, {cur}) of "
                     f"layer {li}, or those rows are not the fresh ones")
        print(f"K6 {name}: the caches changed in rows [{pos}, {cur}) of layer {li} only, "
              f"to the fresh rows")
        return err

    def rand_mask(l, cols):
        mask = torch.rand(l, cols, generator=g, device=dev) > 0.3
        mask[:, 0] = True
        return mask

    errs5, errs6 = [], []
    # K5 at every scale of both seg paths (the full prefix and kv_window=2),
    # on the views the path gives it; every kv_window=2 pos is off the
    # 64-row tiles, so each launch has a ragged seam between the two ranges
    paths = {"full prefix": seg_scales(cfg, None), "kv_window=2": seg_scales(cfg, 2)}
    for pname, scales in paths.items():
        for pos, l in scales:
            errs5.append(k5_case(f"d24 {pname} (pos={pos}, l={l})", *seg_views(R, H, pos, l)))
    # masked and ragged: pos off and on the tiles, l < 64 and l > 128, an
    # `indep` mask slice at the final scale, and pos = 0 (the fresh rows alone)
    for B_, H_, pos, l, masked in ((2, 3, 83, 37, True), (2, 3, 100, 200, True),
                                   (2, 3, 128, 64, True), (2, 3, 0, 5, False),
                                   (2, 3, 0, 100, True)):
        mask = rand_mask(l, pos + l) if masked else None
        errs5.append(k5_case(f"ragged ({B_}, {H_}, {l}, 64), pos={pos}"
                             f"{', masked' if masked else ''}", *seg_views(B_, H_, pos, l), mask))
    mcfg = control_var_config_from_depth(24, multi_cond=True, separate_decoding=True,
                                         indep=True)
    lo, hi = mcfg.begin_ends[-1]
    mask = torch.from_numpy(attn_mask_for_config(mcfg)[lo:hi, :hi]).to(dev)
    if bool(mask.all()):
        fail("K5 indep case: the mask slice masks nothing")
    errs5.append(k5_case(f"d24 indep mask slice (pos={lo}, l={hi - lo})",
                         *seg_views(R, H, lo, hi - lo), mask))

    # K6 on the stacked path's views: the (depth, R, H, L, hd) caches and the
    # fresh k, v straight from the fused QKV; at every scale of the joint
    # path (scale 0 is pos == 0), over layer 0 or 1 in turn
    ck, cv = (randn(2, R, H, cfg.seq_len, hd).to(bf) for _ in range(2))
    scales6 = []
    for si, (lo, hi) in enumerate(cfg.begin_ends):
        qs, kns, vns = fresh(R, H, hi - lo)
        errs6.append(k6_case(f"d24 scale {si} (pos={lo}, l={hi - lo})", qs, ck, cv, kns, vns,
                             si % 2, lo))
        scales6.append((lo, qs, kns, vns))
    q6, kn6, vn6 = scales6[-1][1:]
    full_pos = cfg.begin_ends[-1][0]

    # K5 and SDPA (over the concatenated K/V, made outside the time) at every
    # scale of both seg paths
    def k5_cases(scales):
        for pos, l in scales:
            args = seg_views(R, H, pos, l)
            kk, vv = torch.cat([args[1], args[3]], 2), torch.cat([args[2], args[4]], 2)
            yield (f"pos={pos} l={l}", lambda: decode_attention_prefix(*args, scale),
                   lambda: F.scaled_dot_product_attention(args[0], kk, vv, scale=scale))

    for pname, scales in paths.items():
        scale_times(f"K5 {pname}", k5_cases(scales), cfg.depth, f"{pname} joint call")

    # times at the final scale
    def lib_ms(q, pk, pv, kn, vn):
        kk, vv = torch.cat([pk, kn], dim=2), torch.cat([pv, vn], dim=2)  # outside the time
        return cuda_ms(lambda: F.scaled_dot_product_attention(q, kk, vv, scale=scale), 20)

    def bounds(pos, l, write):
        n = R * H * hd
        nbytes = 2 * (2 * n * l + 2 * n * (pos + l)) + (2 * 2 * n * l if write else 0)
        return bound_ms(nbytes, 4 * R * H * l * (pos + l) * hd, PEAK_BF16_FLOPS)

    times = {}
    for pname, scales in paths.items():
        pos, l = scales[-1]
        args = seg_views(R, H, pos, l)
        b_ms, b_by = bounds(pos, l, False)
        times[pname] = (cuda_ms(lambda: decode_attention_prefix(*args, scale), 20),
                        cuda_ms(lambda: decode_attention_prefix_plain(*args, scale), 3),
                        lib_ms(*args), b_ms, b_by)
        print(f"K5 d24 final scale, {pname}: kernel {times[pname][0]:.4f} ms, plain "
              f"{times[pname][1]:.4f} ms, sdpa over the concatenated K/V "
              f"{times[pname][2]:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    # K6 and SDPA (the attention alone) at every scale
    def k6_cases():
        for pos, qs, kns, vns in scales6:
            kk = torch.cat([ck[1, :, :, :pos], kns], 2)
            vv = torch.cat([cv[1, :, :, :pos], vns], 2)
            yield (f"pos={pos} l={qs.shape[2]}",
                   lambda: decode_attention_inplace(qs, ck, cv, kns, vns, 1, pos, scale),
                   lambda: F.scaled_dot_product_attention(qs, kk, vv, scale=scale))

    scale_times("K6", k6_cases(), cfg.depth, "joint call")
    ms6 = cuda_ms(lambda: decode_attention_inplace(q6, ck, cv, kn6, vn6, 1, full_pos, scale), 20)
    lib6 = lib_ms(q6, ck[1, :, :, :full_pos], cv[1, :, :, :full_pos], kn6, vn6)
    plain6 = cuda_ms(lambda: decode_attention_inplace_plain(q6, ck, cv, kn6, vn6, 1, full_pos,
                                                            scale), 3)
    b6 = bounds(full_pos, q6.shape[2], True)
    print(f"K6 d24 final scale: kernel {ms6:.4f} ms, plain {plain6:.4f} ms, sdpa of the "
          f"attention alone {lib6:.4f} ms, bound {b6[0]:.4f} ms ({b6[1]})")
    w = times["kv_window=2"]
    return (dict(name="decode_attention_prefix", route="cuda",  # K1's kernel, K5's tile load
                 source="controlvar_tpu_torch/csrc/decode_attention.cu",
                 replaces="controlvar_tpu/ops/attention.py:667", max_abs_err=max(errs5),
                 ms=w[0], plain_ms=w[1], bound_ms=w[3], bound_by=w[4], library_ms=w[2]),
            dict(name="decode_attention_inplace", route="cuda",
                 source="controlvar_tpu_torch/csrc/decode_prefix.cu",
                 replaces="controlvar_tpu/ops/attention.py:894", max_abs_err=max(errs6),
                 ms=ms6, plain_ms=plain6, bound_ms=b6[0], bound_by=b6[1], library_ms=lib6))


def flat_fused_phase(torch, cfg12, cfg13):
    """K7 (flat decode) vs its plain version at every scale of the VAR-d13
    path and at hd 32, 96, 128 on a ragged masked shape; K8 (fused decode)
    vs K1 on the same rows (bit-equal) and vs its plain version at every
    scale of the VAR-d12 path, masked and unmasked; times at the final
    scale. Returns the two kernels-line entries."""
    import torch.nn.functional as F

    from controlvar_tpu_torch.ops.attention import (
        decode_attention, decode_attention_flat, decode_attention_flat_plain,
        decode_attention_fused, decode_attention_fused_plain)

    g = torch.Generator(device="cuda").manual_seed(9)
    dev, bf, R_B = "cuda", torch.bfloat16, 128       # B = 64 CFG pairs
    randn = lambda *shape: torch.randn(*shape, generator=g, device=dev)

    def fresh_q(B, H, l, hd):
        """q of std 4 (scores of std ~1 after VAR's 1/(4 sqrt(hd)) scale), the
        strided (B, H, l, hd) view of a fused QKV output, as the blocks give it."""
        return (4 * randn(B, l, 3, H, hd)).to(bf).permute(2, 0, 3, 1, 4)[0]

    def rand_mask(l, cur):
        mask = torch.rand(l, cur, generator=g, device=dev) > 0.3
        mask[:, 0] = True
        return mask

    def timing(name, kernel, plain, q, k, v, scale, nbytes_kv):
        """kernel, plain and SDPA times (SDPA over contiguous K/V made outside
        the time) and the bound of one final-scale launch."""
        B, H, l, hd = q.shape
        ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 3)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 20)
        cur = k.shape[2]
        b_ms, b_by = bound_ms(2 * 2 * q.numel() + nbytes_kv, 4 * B * H * l * cur * hd,
                              PEAK_BF16_FLOPS)
        print(f"{name} final scale (l={l}, cur={cur}): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)

    # K7 over layer 1 of the flat (2, R_B, 13, 64, L) VAR-d13 cache
    H, hd, L, scale = cfg13.num_heads, cfg13.head_dim, cfg13.seq_len, cfg13.attn_scale
    ck, cv = (randn(2, R_B, H, hd, -(-L // 8) * 8).to(bf) for _ in range(2))
    errs7 = []
    for lo, cur in cfg13.begin_ends:
        q = fresh_q(R_B, H, cur - lo, hd)
        got = decode_attention_flat(q, ck, cv, 1, cur, scale)
        kk, vv = ck[1, ..., :cur], cv[1, ..., :cur]
        want = decode_attention_flat_plain(q, kk, vv, scale)
        mag = decode_attention_flat_plain(q, kk, vv.abs(), scale)
        errs7.append(check_close(f"K7 d13 l={cur - lo} cur={cur}", got, want, mag))
    for hd_r in (32, 96, 128):   # other head dims: ragged l and cur, masked
        l, cur, sc = 37, 83, 1.0 / hd_r ** 0.5 / 4
        q = fresh_q(2, 3, l, hd_r)
        ckr, cvr = (randn(2, 2, 3, hd_r, 88).to(bf) for _ in range(2))
        mask = rand_mask(l, cur)
        got = decode_attention_flat(q, ckr, cvr, 1, cur, sc, mask)
        kk, vv = ckr[1, ..., :cur], cvr[1, ..., :cur]
        want = decode_attention_flat_plain(q, kk, vv, sc, mask)
        mag = decode_attention_flat_plain(q, kk, vv.abs(), sc, mask)
        errs7.append(check_close(f"K7 ragged (2, 3, {l}, {hd_r}), cur={cur}, masked", got, want,
                                 mag))
    # K7 and SDPA (over contiguous K/V made outside the time) at every scale
    def k7_cases():
        for lo, cur in cfg13.begin_ends:
            q = fresh_q(R_B, H, cur - lo, hd)
            k_c, v_c = (c[1, ..., :cur].transpose(2, 3).contiguous() for c in (ck, cv))
            yield (f"l={cur - lo} cur={cur}",
                   lambda: decode_attention_flat(q, ck, cv, 1, cur, scale),
                   lambda: F.scaled_dot_product_attention(q, k_c, v_c, scale=scale))

    scale_times("K7", k7_cases(), cfg13.depth, "VAR-d13 call")
    q = fresh_q(R_B, H, L - cfg13.begin_ends[-1][0], hd)
    kk, vv = ck[1, ..., :L], cv[1, ..., :L]
    k_c, v_c = kk.transpose(2, 3).contiguous(), vv.transpose(2, 3).contiguous()
    k7 = dict(name="decode_attention_flat", route="cuda",
              source="controlvar_tpu_torch/csrc/decode_flat.cu",
              replaces="controlvar_tpu/ops/attention.py:240", max_abs_err=max(errs7),
              **timing("K7 d13", lambda: decode_attention_flat(q, ck, cv, 1, L, scale),
                       lambda: decode_attention_flat_plain(q, kk, vv, scale), q, k_c, v_c,
                       scale, 2 * 2 * kk.numel()))
    del ck, cv, k_c, v_c

    # K8 over layer 1 of the fused (2, R_B, 12, L, 128) VAR-d12 cache, K1 over
    # the paired layout's two caches holding the same rows
    H, hd, L, scale = cfg12.num_heads, cfg12.head_dim, cfg12.seq_len, cfg12.attn_scale
    kv = randn(2, R_B, H, L, 2 * hd).to(bf)
    ck, cv = kv[..., :hd].contiguous(), kv[..., hd:].contiguous()
    errs8 = []
    for lo, cur in cfg12.begin_ends:
        for mask in (None, rand_mask(cur - lo, cur)):
            q = fresh_q(R_B, H, cur - lo, hd)
            got = decode_attention_fused(q, kv, 1, cur, scale, mask)
            name = f"K8 d12 l={cur - lo} cur={cur}{' masked' if mask is not None else ''}"
            if not torch.equal(got, decode_attention(q, ck, cv, 1, cur, scale, mask)):
                fail(f"{name}: differs from K1 on the same rows")
            want = decode_attention_fused_plain(q, kv[1, :, :, :cur], scale, mask)
            mag = decode_attention_fused_plain(
                q, torch.cat([kv[1, :, :, :cur, :hd], kv[1, :, :, :cur, hd:].abs()], -1),
                scale, mask)
            errs8.append(check_close(f"{name} (bit-equal to K1)", got, want, mag))
    # B * H = 70,000 > 65535: one item axis, no grid limit
    big = randn(2, 4375, 16, 72, 2 * hd).to(bf)
    q = fresh_q(4375, 16, 8, hd)
    got = decode_attention_fused(q, big, 1, 64, scale)
    want = decode_attention_fused_plain(q, big[1, :, :, :64], scale)
    mag = decode_attention_fused_plain(
        q, torch.cat([big[1, :, :, :64, :hd], big[1, :, :, :64, hd:].abs()], -1), scale)
    errs8.append(check_close("K8 B*H=70000 l=8 cur=64", got, want, mag))
    del big
    # K8 and SDPA (over contiguous K/V made outside the time) at every scale
    def k8_cases():
        for lo, cur in cfg12.begin_ends:
            q = fresh_q(R_B, H, cur - lo, hd)
            k_c, v_c = ck[1, :, :, :cur].contiguous(), cv[1, :, :, :cur].contiguous()
            yield (f"l={cur - lo} cur={cur}",
                   lambda: decode_attention_fused(q, kv, 1, cur, scale),
                   lambda: F.scaled_dot_product_attention(q, k_c, v_c, scale=scale))

    scale_times("K8", k8_cases(), cfg12.depth, "VAR-d12 kv_fused call")
    q = fresh_q(R_B, H, L - cfg12.begin_ends[-1][0], hd)
    k_c, v_c = ck[1, :, :, :L].contiguous(), cv[1, :, :, :L].contiguous()
    k8 = dict(name="decode_attention_fused", route="cuda",
              source="controlvar_tpu_torch/csrc/decode_attention.cu",
              replaces="controlvar_tpu/ops/attention.py:503", max_abs_err=max(errs8),
              **timing("K8 d12", lambda: decode_attention_fused(q, kv, 1, L, scale),
                       lambda: decode_attention_fused_plain(q, kv[1, :, :, :L], scale), q,
                       k_c, v_c, scale, 2 * kv[1, :, :, :L].numel()))
    return k7, k8


def _tiny_train(torch, device, dtype, cos_attn=False):
    """One pre-tokenized train step of a tiny config (hd = 64, L = 42) from
    fixed weights and ids; returns (loss, grad_norm, flattened gradients).
    cos_attn: the config takes it, with the gates raised and scale_mul
    drawn up to the clamp (random_scale_mul)."""
    from controlvar_tpu_torch.config import ControlVARConfig, OptimConfig, VQVAEConfig
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.train.param_groups import named_leaves
    from controlvar_tpu_torch.train.train_step import ControlVARTrainStep, init_train_state

    cfg = ControlVARConfig(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 4),
                           vocab_size=128, cvae=32, num_classes=8, multi_cond=True,
                           cond_drop_rate=0.0, cos_attn=cos_attn)
    vq_cfg = VQVAEConfig(ch=32, patch_nums=(1, 2, 4), vocab_size=128)
    model, vqvae = ControlVARModel(cfg, device=device), VQVAE(vq_cfg, device=device)
    step = ControlVARTrainStep(model, vqvae, OptimConfig(), max_steps=100, warmup_steps=2,
                               device=device)
    step.compute_dtype = dtype
    params = model.init_params(1)
    if cos_attn:
        raise_gates(params)["blocks"]["scale_mul"] = random_scale_mul(
            torch, (2, 2), TINY_COS_SEED).to(device)
    state = init_train_state(params, OptimConfig())
    g = torch.Generator().manual_seed(3)
    ids = lambda: [torch.randint(0, 128, (4, p * p), generator=g) for p in cfg.patch_nums]
    batch = {"ctrl_ids": ids(), "img_ids": ids(), "cls": torch.randint(0, 8, (4,), generator=g),
             "type": torch.randint(0, 4, (4,), generator=g)}
    state, aux = step.step(state, vqvae.init_params(0), batch, from_tokens=True)
    grads = {name: leaf.grad.flatten().double().cpu()
             for name, leaf in named_leaves(state.params)}
    return float(aux["loss"]), float(aux["grad_norm"]), grads


def _decode_inputs(torch, C):
    """Two decode steps' inputs, 4 rows of 2 and then 8 tokens of width C,
    and their condition, from a seed."""
    gx = torch.Generator().manual_seed(2)
    return tuple(torch.randn(4, n, C, generator=gx) for n in (2, 8)) + (
        torch.randn(4, C, generator=gx),)


def _decode_two_steps(torch, cfg, blocks, xs, device, dtype, fused=False, **kw):
    """Two decode steps of `blocks` over the stacked cache of cfg's layout
    (the fused one on request); y of the second, fp32 on the CPU."""
    from controlvar_tpu_torch.device import tree_to
    from controlvar_tpu_torch.models import transformer as tfm

    bp = tree_to(blocks, device, dtype)
    x0, x1, cond = (t.to(device) for t in xs)
    ck, cv = tfm.init_kv_cache(cfg, 4, cfg.seq_len, dtype, device, fused=fused)
    _, ck, cv = tfm.blocks_decode(bp, x0.to(dtype), cond, cfg, ck, cv, 0, **kw)
    y, _, _ = tfm.blocks_decode(bp, x1.to(dtype), cond, cfg, ck, cv, 2, **kw)
    return y.float().cpu()


def reference_phase(torch):
    """Small inputs against the CPU: fp32 tokenizer ids bit-equal; one bf16
    decode step through each decode kernel (K1; K5 in the seg mode; K6 in
    place; K7 over the flat layout; K8 over the fused cache) close to the
    fp32 plain path; one bf16 train step through K3/K4 close to the fp32 CPU
    step."""
    from controlvar_tpu_torch.config import ControlVARConfig, VQVAEConfig
    from controlvar_tpu_torch.device import tree_to
    from controlvar_tpu_torch.models import transformer as tfm
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE

    vq_cfg = VQVAEConfig(ch=32, patch_nums=(1, 2, 4), vocab_size=64)
    vq_cpu = VQVAE(vq_cfg, device="cpu")
    vp = vq_cpu.init_params(0)
    img = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0)) * 2 - 1
    ids_cpu = vq_cpu.img_to_ids(vp, img)
    ids_gpu = VQVAE(vq_cfg, device="cuda").img_to_ids(tree_to(vp, "cuda"), img.cuda())
    for a, b in zip(ids_cpu, ids_gpu):
        if not torch.equal(a, b.cpu()):
            fail("reference: fp32 tokenizer ids on the GPU differ from the CPU's")

    tiny = dict(depth=2, patch_nums=(1, 2, 4), vocab_size=64, cvae=32, num_classes=8,
                multi_cond=True)
    cfg = ControlVARConfig(embed_dim=128, num_heads=2, **tiny)
    # three heads of 64: the flat layout, read by K7
    flat_cfg = ControlVARConfig(embed_dim=192, num_heads=3, **tiny)

    def gated(cfg):
        """The blocks of a tiny config, with the AdaLN gates raised. At init
        the gate columns are 1e-3 of the rest, which leaves the attention
        output out of y: zeroing the whole cached prefix moves y by 7e-7
        (relative L2, fp32 on the CPU). With the attention gate raised by 10
        and the FFN gate by 1 it moves y by 5.7e-2, against bf16 noise of
        3.7e-3 (the CPU's own bf16 step), so the 2e-2 limit below tells them
        apart."""
        return raise_gates(ControlVARModel(cfg, device="cpu").init_params(1))["blocks"]

    inputs = functools.partial(_decode_inputs, torch)

    def run(device, dtype, cfg=cfg, p=gated(cfg), xs=inputs(128), **kw):
        return _decode_two_steps(torch, cfg, p, xs, device, dtype, **kw)

    shared_cfg = ControlVARConfig(embed_dim=128, num_heads=2, shared_aln=True, **tiny)
    shared_p = raise_gates(ControlVARModel(shared_cfg, device="cpu").init_params(1))

    def run_shared(device, dtype, xs=inputs(128)):
        """Two decode steps of a shared_aln model (K1): every layer's
        ada_gss added to the one modulation of shared_ada_lin."""
        bp = tree_to(shared_p["blocks"], device, dtype)
        lin = tree_to(shared_p["shared_ada_lin"], device)
        x0, x1, cond = (t.to(device) for t in xs)
        ck, cv = tfm.init_kv_cache(shared_cfg, 4, shared_cfg.seq_len, dtype, device)
        _, ck, cv = tfm.blocks_decode(bp, x0.to(dtype), cond, shared_cfg, ck, cv, 0,
                                      shared_lin=lin)
        y, _, _ = tfm.blocks_decode(bp, x1.to(dtype), cond, shared_cfg, ck, cv, 2,
                                    shared_lin=lin)
        return y.float().cpu()

    def run_seg(device, dtype, p=gated(cfg), xs=inputs(128)):
        bp = tree_to(p, device, dtype)
        x0, x1, cond = (t.to(device) for t in xs)
        _, k0, v0 = tfm.blocks_decode_seg(bp, x0.to(dtype), cond, cfg, (), ())
        y, _, _ = tfm.blocks_decode_seg(bp, x1.to(dtype), cond, cfg, (k0,), (v0,))
        return y.float().cpu()

    from controlvar_tpu_torch.ops.attention import (decode_attention, decode_attention_flat,
                                                    decode_attention_fused,
                                                    decode_attention_inplace,
                                                    decode_attention_prefix)

    # one step after scale 0, bf16 on the card against fp32 on the CPU: the
    # residual stream is bf16, ~3 significant digits per op, so the relative
    # L2 error is held to 2e-2
    flat = functools.partial(run, cfg=flat_cfg, p=gated(flat_cfg), xs=inputs(192))
    for name, fn, kernel, expect in (
            ("decode step (K1)", run, decode_attention, 4),
            ("seg-mode step (K1, then K5)", run_seg, decode_attention_prefix, 2),
            ("in-place step (K6)", functools.partial(run, inplace=True),
             decode_attention_inplace, 4),
            ("flat-layout step, 3 heads of 64 (K7)", flat, decode_attention_flat, 4),
            ("fused-cache step (K8)", functools.partial(run, fused=True),
             decode_attention_fused, 4),
            ("shared_aln decode step (K1)", run_shared, decode_attention, 4)):
        want = fn("cpu", torch.float32)
        kernel.launches = 0
        got = fn("cuda", torch.bfloat16)
        rel = float((got - want).norm() / want.norm())
        print(f"reference: bf16 GPU {name} vs fp32 CPU: relative error {rel:.3e}, "
              f"{kernel.launches} launches")
        if rel > 2e-2:
            fail(f"reference: {name} relative error {rel:.3e} > 2e-2")
        if kernel.launches != expect:
            fail(f"reference: {name} launched its kernel {kernel.launches} times, not {expect}")
    print("reference: tokenizer ids equal")

    _check_train_step(torch, "train step", _tiny_train)
    _check_train_step(torch, "shared_aln VAR train step",
                      functools.partial(_tiny_var_train, shared_aln=True))
    from controlvar_tpu_torch import native

    if not native.available():
        fail("reference: the native RLE library did not build")
    print("reference: the native RLE library builds and loads (native.available())")


def random_scale_mul(torch, shape, seed):
    """cos_attn's scale_mul drawn uniform in [0, log COS_SCALE_MAX] from a
    seed: q is scaled by exp(min(s, log 100)), so the heads above log 100
    clamp (scores up to +-100 at scale 1) and the rest do not; fails unless
    both kinds occur."""
    import math

    s = torch.rand(shape, generator=torch.Generator().manual_seed(seed)) * math.log(COS_SCALE_MAX)
    clamped = s > math.log(100.0)
    print(f"scale_mul {tuple(shape)} from seed {seed}: {int(clamped.sum())} of {s.numel()} "
          f"heads clamped at log 100, the largest exp(s) {math.exp(float(s.max())):.1f}")
    if not bool(clamped.any()) or bool(clamped.all()):
        fail(f"scale_mul from seed {seed}: {int(clamped.sum())} of {s.numel()} heads clamped")
    return s


def raise_gates(params):
    """params with the AdaLN gates raised in place (attention by 10, FFN by
    1; the ada_lin bias, or ada_gss under shared_aln): at init they are 1e-3
    of the rest, which leaves attention out of the outputs."""
    b = params["blocks"]
    if "ada_gss" in b:
        b["ada_gss"][:, 0] += 10.0
        b["ada_gss"][:, 1] += 1.0
    else:
        C = b["ada_lin"]["bias"].shape[1] // 6
        b["ada_lin"]["bias"][:, :C] += 10.0
        b["ada_lin"]["bias"][:, C: 2 * C] += 1.0
    return params


def _grad_cosines(torch, got, want):
    """The cosine of the whole flattened gradient and of each block leaf's."""
    cosine = lambda a, b: float(a @ b / (a.norm() * b.norm()))
    return (cosine(torch.cat(list(got.values())), torch.cat(list(want.values()))),
            {name: cosine(got[name], want[name]) for name in want if name.startswith("blocks/")})


def _check_train_step(torch, label, run, bf16_floor=False):
    """`run(torch, device, dtype)`, a tiny-config train step, bf16 on the
    card against fp32 on the CPU: the loss within TRAIN_LOSS_RTOL, the
    cosine of the whole gradient and of each block leaf's within theirs,
    and the card's K3/K4 launches (2 layers: forward and recompute, and one
    backward each). bf16_floor: where bf16 arithmetic alone misses those
    cosines (cos_attn with heads at the clamp, COS_BF16_FLOOR), the CPU's
    own bf16 step on the same inputs is run too, and each cosine of the
    card's step is held within twice its distance from 1, never tighter
    than the limits above."""
    from controlvar_tpu_torch.ops.attention import flash_attention, flash_attention_bwd

    flash_attention.launches = flash_attention_bwd.launches = 0
    loss_c, norm_c, grad_c = run(torch, "cpu", torch.float32)
    loss_g, norm_g, grad_g = run(torch, "cuda", torch.bfloat16)
    counts = (flash_attention.launches, flash_attention_bwd.launches)
    rel = abs(loss_g - loss_c) / abs(loss_c)
    cos, leaf_cos = _grad_cosines(torch, grad_g, grad_c)
    cos_lim, leaf_lim = TRAIN_GRAD_COS, dict.fromkeys(leaf_cos, TRAIN_BLOCK_LEAF_COS)
    if bf16_floor:
        floor, floor_leaf = _grad_cosines(torch, run(torch, "cpu", torch.bfloat16)[2], grad_c)
        widen = lambda base, c: min(base, 1.0 - 2.0 * (1.0 - c))
        cos_lim = widen(cos_lim, floor)
        leaf_lim = {name: widen(leaf_lim[name], c) for name, c in floor_leaf.items()}
        print(f"reference: {label}, the CPU's own bf16 step vs fp32: gradient cosine "
              f"{floor:.6f}; each block leaf's: " + ", ".join(
                  f"{name} {c:.6f}" for name, c in sorted(floor_leaf.items())))
    worst = min(leaf_cos, key=lambda name: (leaf_cos[name] - leaf_lim[name]))
    print(f"reference: bf16 GPU {label} vs fp32 CPU: loss {loss_g:.6f} vs {loss_c:.6f} "
          f"(relative {rel:.3e}), grad_norm {norm_g:.6f} vs {norm_c:.6f}, gradient "
          f"cosine {cos:.6f} (limit {cos_lim:.6f}), launches K3={counts[0]} K4={counts[1]}")
    print(f"reference: {label}, gradient cosine of each block leaf (limit): " + ", ".join(
        f"{name} {c:.6f} ({leaf_lim[name]:.6f})" for name, c in sorted(leaf_cos.items())))
    if counts != (4, 2):
        fail(f"reference: {label} launches (K3, K4) = {counts}, expected (4, 2)")
    if not rel <= TRAIN_LOSS_RTOL:
        fail(f"reference: {label} loss relative difference {rel:.3e} > {TRAIN_LOSS_RTOL:g}")
    if not cos >= cos_lim:
        fail(f"reference: {label} gradient cosine {cos:.6f} < {cos_lim:.6f}")
    if not leaf_cos[worst] >= leaf_lim[worst]:
        fail(f"reference: {label} gradient cosine of {worst} {leaf_cos[worst]:.6f} < "
             f"{leaf_lim[worst]:.6f}")


def _pixel_batch(torch, B, num_classes, seed, control=True):
    """B seeded 256x256 images in [-1, 1] with their classes, on the card;
    with control, the control images and cond types too."""
    g = torch.Generator().manual_seed(seed)
    img = lambda: (torch.rand(B, 256, 256, 3, generator=g) * 2 - 1).cuda()
    batch = {"image": img()}
    if control:
        batch["mask"] = img()
    batch["cls"] = torch.randint(0, num_classes, (B,), generator=g).cuda()
    if control:
        batch["type"] = torch.randint(0, 4, (B,), generator=g).cuda()
    return batch


ADALN_SITES = ("adaln_norm", "adaln_add_norm", "adaln_add")


def _reset_adaln(adaln) -> None:
    for name in ADALN_SITES:
        getattr(adaln, name).launches = getattr(adaln, name).bwd_launches = 0


def _adaln_launches(adaln) -> tuple:
    """The AdaLN kernels' launches since the last _reset_adaln, in ADALN_SITES' order."""
    return tuple(getattr(adaln, name).launches for name in ADALN_SITES)


def _adaln_per_step(depth):
    """(forward, backward) launches of each AdaLN site a train step: the
    forward and the recompute of every layer under each remat policy (full,
    dots, dots_attn: the kernels are not aten ops, so no policy saves their
    outputs), and one backward a layer."""
    return 2 * depth, depth


def _adaln_bwd_launches(adaln) -> tuple:
    return tuple(getattr(adaln, name).bwd_launches for name in ADALN_SITES)


def _timed_steps(torch, label, step_fn, expect, n_timed, B, adaln_expect, profile_tag=None):
    """One warm-up step, then n_timed timed ones, each ended by a
    synchronize, with the K3/K4 launches of each held to `expect`, each
    AdaLN site's (forward, backward) launches to `adaln_expect`
    (`_adaln_per_step`), and the loss and grad_norm finite; with
    profile_tag, one more step under the profiler (device busy time, idle
    share, time by category). Returns (s/step, peak GiB of the timed steps,
    the warm-up loss)."""
    import math

    from controlvar_tpu_torch.ops import adaln
    from controlvar_tpu_torch.ops.attention import flash_attention, flash_attention_bwd

    def one():
        flash_attention.launches = flash_attention_bwd.launches = 0
        _reset_adaln(adaln)
        torch.cuda.synchronize()
        t = time.perf_counter()
        aux = step_fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = (flash_attention.launches, flash_attention_bwd.launches)
        if counts != expect:
            fail(f"{label}: launches (K3, K4) = {counts}, expected {expect}")
        # under autograd the blocks take the Functions (ops/adaln.py)
        got = (_adaln_launches(adaln), _adaln_bwd_launches(adaln))
        if got != ((adaln_expect[0],) * 3, (adaln_expect[1],) * 3):
            fail(f"{label}: AdaLN (forward, backward) launches {got}, expected "
                 f"{adaln_expect} a site")
        loss, norm = float(aux["loss"]), float(aux["grad_norm"])
        if not (math.isfinite(loss) and math.isfinite(norm)):
            fail(f"{label}: loss {loss} grad_norm {norm}")
        return dt, loss, aux

    dt, loss0, aux = one()
    print(f"{label}: warm-up step {dt:.3f} s, loss {loss0:.5f}, grad_norm "
          f"{float(aux['grad_norm']):.5f}, lr {aux['lr']:.3e}")
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(n_timed):
        dt, loss, aux = one()
        times.append(dt)
        losses.append(loss)
    s_step = sum(times) / n_timed
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label}: {n_timed} timed steps {', '.join(f'{t:.4f}' for t in times)} s; "
          f"mean {s_step:.4f} s/step = {B / s_step:.3f} img/s; peak memory {peak:.2f} GiB; "
          f"losses {', '.join(f'{x:.5f}' for x in losses)}; launches per step "
          f"K3={expect[0]} K4={expect[1]}, each AdaLN site {adaln_expect[0]} forward and "
          f"{adaln_expect[1]} backward")
    if profile_tag:
        busy, wall, by_cat = device_profile(torch, lambda: one()[0], profile_tag)
        # the profiler slows the host, so the profiled step's idle share
        # overstates an unprofiled step's; both are printed
        print(f"{profile_tag} breakdown: profiled step {wall:.2f} ms, device busy {busy:.2f} "
              f"ms, idle share {1 - busy / wall:.4f} of the profiled step, "
              f"{1 - busy / (s_step * 1e3):.4f} of the mean timed step")
        for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
            print(f"{profile_tag} breakdown: {cat}: {ms:.2f} ms")
    return s_step, peak, loss0


def _launches_per_step(depth, remat):
    """(K3, K4) a train step: the forward of each layer, and its recompute
    except under dots_attn; one backward each."""
    return (depth if remat == "dots_attn" else 2 * depth, depth)


def train_path_phase(torch, cfg, profile: bool):
    """The training path at full width, under the default remat policy and
    then under dots and dots_attn. Returns ((K3, K4) launches of a default
    step, its s/step, {policy: (s/step, peak GiB, K3 a step)})."""
    import math

    from controlvar_tpu_torch.config import OptimConfig, VQVAEConfig
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.train.train_step import ControlVARTrainStep, init_train_state

    B, n_timed = 8, 5
    t0 = time.time()
    model, vqvae = ControlVARModel(cfg), VQVAE(VQVAEConfig())
    optim = OptimConfig(total_batch_size=B)
    stepper = ControlVARTrainStep(model, vqvae, optim, max_steps=1000, warmup_steps=10)
    state = init_train_state(model.init_params(0), optim)
    vq_params = vqvae.init_params(1)
    batch = _pixel_batch(torch, B, cfg.num_classes, 5)
    n_params = sum(t.numel() for t in state.optimizer.param_groups[0]["params"]) + sum(
        t.numel() for t in state.optimizer.param_groups[1]["params"])
    head0 = state.params["head"]["kernel"].detach().clone()
    gen = torch.Generator().manual_seed(6)
    print(f"train path: d16 params ({n_params / 1e6:.1f} M) and ch-160 VQVAE built in "
          f"{time.time() - t0:.1f} s")
    step_fn = lambda: stepper.step(state, vq_params, batch, gen)[1]
    expect = _launches_per_step(cfg.depth, "full")
    s_step, peak, loss0 = _timed_steps(torch, "train path", step_fn, expect, n_timed, B,
                                       _adaln_per_step(cfg.depth), "train" if profile else None)
    print(f"train path: step-0 loss {loss0:.5f}, ln V = {math.log(cfg.vocab_size):.5f}")
    if abs(loss0 - math.log(cfg.vocab_size)) > 0.5:
        fail(f"train path: step-0 loss {loss0:.4f} is not near ln V")
    if float((state.params["head"]["kernel"].detach() - head0).abs().max()) == 0.0:
        fail("train path: the params did not change")
    policies = {"full": (s_step, peak, expect[0])}
    for remat in ("dots", "dots_attn"):
        stepper.remat = remat
        k34 = _launches_per_step(cfg.depth, remat)
        s_r, peak_r, _ = _timed_steps(torch, f"train path, remat {remat}", step_fn, k34,
                                      3, B, _adaln_per_step(cfg.depth),
                                      f"train_{remat}" if profile else None)
        policies[remat] = (s_r, peak_r, k34[0])
    print("remat policies, d16 B=8 step: " + "; ".join(
        f"{r} {v[0]:.4f} s/step, peak {v[1]:.2f} GiB, K3 {v[2]} a step"
        for r, v in policies.items()))
    return expect, s_step, policies


def _assert_trees_equal(torch, label, got, want) -> int:
    """Every leaf of `got` equal to `want`'s bit for bit, on the card, fp32;
    returns the leaf count."""
    from controlvar_tpu_torch.train.param_groups import named_leaves

    got, want = dict(named_leaves(got)), dict(named_leaves(want))
    if sorted(got) != sorted(want):
        fail(f"{label}: leaves differ: {sorted(set(got) ^ set(want))}")
    for name, w in want.items():
        g = got[name]
        if g.device.type != "cuda" or g.dtype != torch.float32 or g.shape != w.shape:
            fail(f"{label}: {name} is {g.dtype} {tuple(g.shape)} on {g.device}")
        if not torch.equal(g, w):
            fail(f"{label}: {name} differs")
    return len(want)


def _scratch_dir():
    """A directory for the files a phase writes, under the checkout's
    build/ (listed in .gitignore), removed by the caller."""
    import tempfile

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    return tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"))


def ckpt_phase(torch, var_cfg):
    """The .pth round trip at d16: VAR-d16 and the ch-160 VQVAE, initialized
    by the port from seeds, exported, written with save_torch_checkpoint,
    read back with load_torch_state_dict and converted onto the card; every
    leaf bit for bit. Returns the VAR-d16 params."""
    from controlvar_tpu_torch.ckpt import torch_export, torch_import
    from controlvar_tpu_torch.config import VQVAEConfig
    from controlvar_tpu_torch.models.var import VARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE

    var_params = VARModel(var_cfg).init_params(0)
    vq_cfg = VQVAEConfig()
    models = (("VAR-d16", var_params, var_cfg, torch_export.export_var_state_dict,
               torch_import.convert_var_state_dict),
              ("VQVAE ch-160", VQVAE(vq_cfg).init_params(1), vq_cfg,
               torch_export.export_vqvae_state_dict, torch_import.convert_vqvae_state_dict))
    with _scratch_dir() as d:
        for name, params, cfg, export, convert in models:
            t = time.perf_counter()
            path = os.path.join(d, "ckpt.pth")
            sd = export(params, cfg)
            torch_export.save_torch_checkpoint(path, sd, step=1)
            size = os.path.getsize(path)
            back = convert(torch_import.load_torch_state_dict(path), cfg)
            n = _assert_trees_equal(torch, f"checkpoint {name}", back, params)
            print(f"checkpoint: {name}: {len(sd)} state-dict entries, {size / 1e6:.1f} MB "
                  f".pth, {n} leaves on the card equal bit for bit after export, save, load "
                  f"and import ({time.perf_counter() - t:.1f} s)")
            os.remove(path)
            del back, sd
    return var_params


def finetune_phase(torch, cfg, var_params, profile: bool):
    """The fine-tuning path at d16: VAR-d16 -> ControlVAR-d16 surgery
    (concat), LoRA rank 16 / alpha 32 steps at B=8 on the train path's
    batches, the LoRA state saved with CheckpointIO and restored into a
    fresh one, and merge_lora -> export -> import. Returns ((K3, K4) a
    step, s/step, peak GiB)."""
    from controlvar_tpu_torch.ckpt import torch_export, torch_import
    from controlvar_tpu_torch.ckpt.lora import LoRAConfig, merge_lora
    from controlvar_tpu_torch.ckpt.orbax_io import CheckpointIO
    from controlvar_tpu_torch.ckpt.surgery import var_to_control_var
    from controlvar_tpu_torch.config import OptimConfig, VQVAEConfig
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.train.param_groups import named_leaves
    from controlvar_tpu_torch.train.train_step import (ControlVARTrainStep,
                                                       LoRAControlVARTrainStep)

    B = 8
    model, vqvae = ControlVARModel(cfg), VQVAE(VQVAEConfig())
    base = var_to_control_var(var_params, model.init_params(2), cfg, mode="concat")
    pos = var_params["pos_1LC"]
    if not torch.equal(base["pos_1LC"], torch.cat([pos, pos], dim=1)):
        fail("fine-tune: pos_1LC is not [pos; pos]")
    n = _assert_trees_equal(torch, "fine-tune surgery blocks", base["blocks"],
                            var_params["blocks"])
    print(f"fine-tune: VAR-d16 -> ControlVAR-d16 multi_cond (concat): pos_1LC == [pos; pos] "
          f"{tuple(base['pos_1LC'].shape)}, {n} block leaves equal")
    # as a whole-model train state leaves them: the LoRA step must still give
    # them no gradient
    for _, leaf in named_leaves(base):
        leaf.requires_grad_(True)
    before = {name: leaf.detach().clone() for name, leaf in named_leaves(base)}
    optim = OptimConfig(total_batch_size=B)
    lcfg = LoRAConfig(rank=16, alpha=32.0)
    lora_step = LoRAControlVARTrainStep(
        ControlVARTrainStep(model, vqvae, optim, max_steps=1000, warmup_steps=10), lcfg)
    state = lora_step.init_lora_state(torch.Generator().manual_seed(7), base, optim)
    vq_params = vqvae.init_params(1)
    batch = _pixel_batch(torch, B, cfg.num_classes, 5)
    gen = torch.Generator().manual_seed(8)
    expect = _launches_per_step(cfg.depth, "full")
    s_step, peak, _ = _timed_steps(
        torch, "fine-tune (LoRA r16)", lambda: lora_step.step(state, base, vq_params, batch,
                                                              gen)[1], expect, 3, B,
        _adaln_per_step(cfg.depth), "finetune" if profile else None)
    n_lora = sum(t.numel() for _, t in named_leaves(state.params))
    for name, leaf in named_leaves(base):
        if leaf.grad is not None:
            fail(f"fine-tune: base leaf {name} has a gradient")
        if not torch.equal(leaf.detach(), before[name]):
            fail(f"fine-tune: base leaf {name} changed")
    for key, ab in state.params.items():
        if float(ab["B"].detach().abs().max()) == 0.0:
            fail(f"fine-tune: LoRA B of {key} is still zero after 4 steps")
    print(f"fine-tune: {n_lora / 1e6:.2f} M LoRA params in {len(state.params)} targets; base "
          f"leaves unchanged bit for bit, none with a gradient; every B non-zero")
    del before

    with _scratch_dir() as d:
        io = CheckpointIO(d)
        io.save(state.step, state, metadata={"epoch": 0})
        fresh = lora_step.init_lora_state(torch.Generator().manual_seed(9), base, optim)
        restored, meta = io.restore(fresh)
    if restored.step != state.step or meta != {"epoch": 0}:
        fail(f"fine-tune: restored step {restored.step}, metadata {meta}")
    _assert_trees_equal(torch, "fine-tune restore: params", restored.params, state.params)
    want_opt, got_opt = state.optimizer.state_dict(), restored.optimizer.state_dict()
    for i, moments in want_opt["state"].items():
        for name in ("exp_avg", "exp_avg_sq"):
            got = got_opt["state"][i][name]
            if got.device.type != "cuda" or not torch.equal(got, moments[name]):
                fail(f"fine-tune restore: Adam {name} of param {i} differs or is on {got.device}")
        if float(got_opt["state"][i]["step"]) != float(moments["step"]):
            fail(f"fine-tune restore: Adam step of param {i} differs")
    print(f"fine-tune: CheckpointIO save at step {state.step} and restore into a fresh state: "
          f"params, Adam moments (on the card) and step equal")

    merged = merge_lora(base, state.params, lcfg)
    back = torch_import.convert_control_var_state_dict(
        torch_export.export_control_var_state_dict(merged, cfg), cfg)
    n = _assert_trees_equal(torch, "fine-tune merge", back, merged)
    print(f"fine-tune: merge_lora -> export -> import: {n} leaves equal bit for bit")
    return expect, s_step, peak


def _tiny_var_train(torch, device, dtype, shared_aln=False):
    """One pixel step of VARTrainStep at a tiny config (hd = 64, L = 21;
    with shared_aln, the AdaLN modulations from shared_ada_lin) from fixed
    weights and images, the fp32 tokenizer on both devices (its ids are
    equal there); returns (loss, grad_norm, flattened gradients)."""
    from controlvar_tpu_torch.config import OptimConfig, VARConfig, VQVAEConfig
    from controlvar_tpu_torch.models.var import VARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.train.param_groups import named_leaves
    from controlvar_tpu_torch.train.train_step import VARTrainStep, init_train_state

    cfg = VARConfig(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 4), vocab_size=128,
                    cvae=32, num_classes=8, cond_drop_rate=0.0, shared_aln=shared_aln)
    vq_cfg = VQVAEConfig(ch=32, patch_nums=(1, 2, 4), vocab_size=128)
    model, vqvae = VARModel(cfg, device=device), VQVAE(vq_cfg, device=device)
    step = VARTrainStep(model, vqvae, OptimConfig(), max_steps=100, warmup_steps=2,
                        device=device)
    step.tokenize_dtype, step.compute_dtype = torch.float32, dtype
    state = init_train_state(model.init_params(1), OptimConfig())
    g = torch.Generator().manual_seed(3)
    batch = {"image": torch.rand(4, 64, 64, 3, generator=g) * 2 - 1,
             "cls": torch.randint(0, 8, (4,), generator=g)}
    state, aux = step.step(state, vqvae.init_params(0), batch)
    grads = {name: leaf.grad.flatten().double().cpu()
             for name, leaf in named_leaves(state.params)}
    return float(aux["loss"]), float(aux["grad_norm"]), grads


def var_train_phase(torch, var_cfg, var_params, profile: bool):
    """The VAR-d16 train step at B=8 with configs/train_var_imagenet_d16.yaml's
    recipe, seeded 256x256 images tokenized inside the step; then a tiny
    bf16 VAR step on the card against the fp32 CPU step. Returns ((K3, K4)
    a step, s/step, peak GiB)."""
    from controlvar_tpu_torch.config import OptimConfig, VQVAEConfig
    from controlvar_tpu_torch.models.var import VARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.train.train_step import VARTrainStep, init_train_state

    B = 8
    # the recipe: drop path 0.1, cond drop 0.1, lr 1e-5 (base, scaled by
    # B / 512 as the CLI scales it), wd 1e-4, cosine, 100 epochs
    optim = OptimConfig(base_lr=1e-5, weight_decay=1e-4, schedule="cos", epochs=100,
                        total_batch_size=B)
    model, vqvae = VARModel(var_cfg), VQVAE(VQVAEConfig())
    stepper = VARTrainStep(model, vqvae, optim, max_steps=1000, warmup_steps=10)
    state = init_train_state(var_params, optim)
    vq_params = vqvae.init_params(1)
    batch = _pixel_batch(torch, B, var_cfg.num_classes, 11, control=False)
    gen = torch.Generator().manual_seed(12)
    expect = _launches_per_step(var_cfg.depth, "full")
    s_step, peak, _ = _timed_steps(
        torch, "VAR-d16 train", lambda: stepper.step(state, vq_params, batch, gen)[1], expect,
        5, B, _adaln_per_step(var_cfg.depth), "var_train" if profile else None)
    _check_train_step(torch, "VAR train step", _tiny_var_train)
    return expect, s_step, peak


def main_path_phase(torch, cfg, profile: bool):
    from controlvar_tpu_torch.config import SampleConfig, VQVAEConfig
    from controlvar_tpu_torch.eval.harness import SamplingHarness
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.ops import adaln
    from controlvar_tpu_torch.ops.attention import decode_attention
    from controlvar_tpu_torch.ops.sample_kernel import sample_top_k_top_p_bisect

    B = 16
    t0 = time.time()
    model, vqvae = ControlVARModel(cfg), VQVAE(VQVAEConfig())
    harness = SamplingHarness(model, vqvae, SampleConfig())
    params = harness.prepare_params(model.init_params(0))
    vq_params = vqvae.init_params(1)
    g = torch.Generator().manual_seed(3)
    labels = torch.randint(0, cfg.num_classes, (B,), generator=g)
    cond_type = torch.randint(0, 4, (B,), generator=g)
    imgs = (torch.rand(B, 256, 256, 3, generator=g) * 2 - 1).cuda()
    print(f"main path: d16 params and ch-160 VQVAE built in {time.time() - t0:.1f} s")

    def call(seed):
        decode_attention.launches = sample_top_k_top_p_bisect.launches = 0
        _reset_adaln(adaln)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = harness.control_conditioned(params, vq_params, labels, cond_type,
                                          torch.Generator().manual_seed(seed), imgs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = (decode_attention.launches, sample_top_k_top_p_bisect.launches)
        if counts != (cfg.depth * cfg.num_scales, cfg.num_scales):
            fail(f"main path: launches (K1, K2) = {counts}, expected "
                 f"({cfg.depth * cfg.num_scales}, {cfg.num_scales})")
        # one launch of each AdaLN kernel a layer-step
        counts += _adaln_launches(adaln)
        if counts[2:] != (cfg.depth * cfg.num_scales,) * 3:
            fail(f"main path: AdaLN launches {counts[2:]}, expected "
                 f"{cfg.depth * cfg.num_scales} each")
        for t_ in out:
            if tuple(t_.shape) != (B, 256, 256, 3) or not torch.isfinite(t_).all():
                fail(f"main path: bad canvas {tuple(t_.shape)}")
            if float(t_.min()) < 0.0 or float(t_.max()) > 1.0:
                fail("main path: canvas outside [0, 1]")
        return dt, counts

    dt_warm, _ = call(10)
    dt, counts = call(11)
    print(f"main path: warm-up call {dt_warm:.3f} s; timed call {dt:.4f} s for "
          f"{B} images = {B / dt:.3f} img/s; launches K1={counts[0]} K2={counts[1]} "
          + " ".join(f"{n}={c}" for n, c in zip(ADALN_SITES, counts[2:])))
    if profile:
        breakdown(torch, call,
                  lambda: harness.control_conditioned(params, vq_params, labels, cond_type,
                                                      torch.Generator().manual_seed(12),
                                                      imgs, decode_img=False),
                  lambda: harness._tokenize(vq_params, imgs),
                  lambda fh: vqvae.fhat_to_img(vq_params, fh, harness.compute_dtype), dt)
    return counts, B / dt


def joint_path_phase(torch, cfg, profile: bool):
    """The joint path at full width in its three cache modes; returns
    {mode: ((K1, K2, K5, K6) launches of the timed call, img/s)}."""
    from controlvar_tpu_torch.config import SampleConfig, VQVAEConfig
    from controlvar_tpu_torch.eval.harness import SamplingHarness
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.ops.attention import (decode_attention, decode_attention_inplace,
                                                    decode_attention_prefix)
    from controlvar_tpu_torch.ops.sample_kernel import sample_top_k_top_p_bisect

    B, D, S = 8, cfg.depth, cfg.num_scales
    kernels = (decode_attention, sample_top_k_top_p_bisect, decode_attention_prefix,
               decode_attention_inplace)
    t0 = time.time()
    model, vqvae = ControlVARModel(cfg), VQVAE(VQVAEConfig())
    modes = {"stacked": (SamplingHarness(model, vqvae, SampleConfig()), (D * S, S, 0, 0)),
             "kv_window=2": (SamplingHarness(model, vqvae, SampleConfig(kv_window=2)),
                             (D, S, D * (S - 1), 0)),
             "inplace_decode": (SamplingHarness(model, vqvae, SampleConfig(),
                                                inplace_decode=True), (0, S, 0, D * S))}
    params = modes["stacked"][0].prepare_params(model.init_params(0))
    vq_params = vqvae.init_params(1)
    labels = torch.arange(B) % cfg.num_classes
    cond_type = torch.arange(B) % 4
    print(f"joint path: d24 params and ch-160 VQVAE built in {time.time() - t0:.1f} s")

    def call(mode, seed):
        harness, expect = modes[mode]
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = harness.joint(params, vq_params, labels, cond_type,
                            torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = tuple(k.launches for k in kernels)
        if counts != expect:
            fail(f"joint path, {mode}: launches (K1, K2, K5, K6) = {counts}, expected {expect}")
        for t_ in out:
            if tuple(t_.shape) != (B, 256, 256, 3) or not torch.isfinite(t_).all():
                fail(f"joint path, {mode}: bad canvas {tuple(t_.shape)}")
            if float(t_.min()) < 0.0 or float(t_.max()) > 1.0:
                fail(f"joint path, {mode}: canvas outside [0, 1]")
        return dt, counts

    results = {}
    for mode in modes:
        dt_warm, _ = call(mode, 20)
        dt, counts = call(mode, 21)
        results[mode] = (counts, B / dt)
        print(f"joint path, {mode}: warm-up call {dt_warm:.3f} s; timed call {dt:.4f} s for "
              f"{B} images = {B / dt:.3f} img/s; launches K1={counts[0]} K2={counts[1]} "
              f"K5={counts[2]} K6={counts[3]}")
        if profile:
            tag = "joint_" + mode.replace("=", "").replace("_decode", "")
            busy, wall, by_cat = device_profile(torch, lambda: call(mode, 22)[0], tag)
            print(f"{tag} breakdown: profiled call {wall:.2f} ms, device busy {busy:.2f} ms, "
                  f"idle share {1 - busy / wall:.4f} of the profiled call, "
                  f"{1 - busy / (dt * 1e3):.4f} of the timed call")
            for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
                print(f"{tag} breakdown: {cat}: {ms:.2f} ms")
    alternated(call, list(modes), B, "joint path")
    return results


def alternated(call, modes, B, label, rounds: int = 4):
    """A call's host clock varies by ~30% from call to call on the generation
    paths (the host bounds them), so one timed call per mode cannot rank the
    modes: `rounds` more rounds, each calling every mode once in a rotated
    order, and the median of each mode's calls."""
    times = {mode: [] for mode in modes}
    for rnd in range(rounds):
        for mode in modes[rnd % len(modes):] + modes[: rnd % len(modes)]:
            times[mode].append(call(mode, 30 + rnd)[0])
    for mode, ts in times.items():
        ts.sort()
        med = 0.5 * (ts[(rounds - 1) // 2] + ts[rounds // 2])
        print(f"{label}, alternated, {mode}: calls {', '.join(f'{x:.4f}' for x in ts)} s; "
              f"median {med:.4f} s = {B / med:.3f} img/s")


def var_path_phase(torch, cfg, modes, profile: bool, timed_rounds: bool):
    """VAR class-conditional generation at full width (BASELINE config 2:
    B = 64, labels arange(64) % 1000, cfg 1.5, top-k 900, top-p 0.96, images
    decoded), one warm-up and one timed call in each mode ({name: sampler
    arguments}), then, with timed_rounds, four alternated rounds. Returns
    {mode: ((K1, K2, K7, K8) launches of the timed call, img/s)}."""
    from controlvar_tpu_torch.config import VQVAEConfig
    from controlvar_tpu_torch.eval.stepwise import StepwiseVARSampler
    from controlvar_tpu_torch.models import transformer as tfm
    from controlvar_tpu_torch.models.var import VARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.ops.attention import (decode_attention, decode_attention_flat,
                                                    decode_attention_fused)
    from controlvar_tpu_torch.ops.sample_kernel import sample_top_k_top_p_bisect

    B, D, S = 64, cfg.depth, cfg.num_scales
    tag = f"VAR-d{D}"
    kernels = (decode_attention, sample_top_k_top_p_bisect, decode_attention_flat,
               decode_attention_fused)
    t0 = time.time()
    model, vqvae = VARModel(cfg), VQVAE(VQVAEConfig())
    samplers = {mode: StepwiseVARSampler(model, vqvae, cfg_scale=1.5, top_k=900, top_p=0.96,
                                         **kw) for mode, kw in modes.items()}
    flat = tfm.kv_layout(cfg) == "flat"
    expect = {mode: (0 if flat or s.kv_fused else D * S, S, D * S if flat else 0,
                     D * S if s.kv_fused else 0) for mode, s in samplers.items()}
    params = next(iter(samplers.values())).prepare_params(model.init_params(0))
    vq_params = vqvae.init_params(1)
    labels = torch.arange(B) % cfg.num_classes
    print(f"{tag} path: params and ch-160 VQVAE built in {time.time() - t0:.1f} s")

    def call(mode, seed):
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = samplers[mode](params, vq_params, labels, torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = tuple(k.launches for k in kernels)
        if counts != expect[mode]:
            fail(f"{tag} path, {mode}: launches (K1, K2, K7, K8) = {counts}, expected "
                 f"{expect[mode]}")
        if tuple(out.shape) != (B, 256, 256, 3) or not torch.isfinite(out).all():
            fail(f"{tag} path, {mode}: bad images {tuple(out.shape)}")
        if float(out.min()) < 0.0 or float(out.max()) > 1.0:
            fail(f"{tag} path, {mode}: images outside [0, 1]")
        return dt, counts

    results = {}
    for mode in modes:
        dt_warm, _ = call(mode, 40)
        dt, counts = call(mode, 41)
        results[mode] = (counts, B / dt)
        print(f"{tag} path, {mode}: warm-up call {dt_warm:.3f} s; timed call {dt:.4f} s for "
              f"{B} images = {B / dt:.3f} img/s; launches K1={counts[0]} K2={counts[1]} "
              f"K7={counts[2]} K8={counts[3]}")
        if profile:
            ptag = f"var_d{D}_" + mode.replace("=", "")
            busy, wall, by_cat = device_profile(torch, lambda: call(mode, 42)[0], ptag)
            print(f"{ptag} breakdown: profiled call {wall:.2f} ms, device busy {busy:.2f} ms, "
                  f"idle share {1 - busy / wall:.4f} of the profiled call, "
                  f"{1 - busy / (dt * 1e3):.4f} of the timed call")
            for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
                print(f"{ptag} breakdown: {cat}: {ms:.2f} ms")
    if timed_rounds:
        alternated(call, list(modes), B, f"{tag} path")
    return results


@contextlib.contextmanager
def recorded_draws(*modules):
    """The id tensors of every draw made through the modules'
    `sample_top_k_top_p`, in order."""
    calls, saved = [], [(m, m.sample_top_k_top_p) for m in modules]

    def spy(orig):
        def draw(*args, **kwargs):
            calls.append(orig(*args, **kwargs))
            return calls[-1]
        return draw

    for m, orig in saved:
        m.sample_top_k_top_p = spy(orig)
    try:
        yield calls
    finally:
        for m, orig in saved:
            m.sample_top_k_top_p = orig


def _reset(*kernels):
    for k in kernels:
        k.launches = 0


def separator_data_phase(torch, cfg, profile: bool):
    """The data path into a separator/type_pos step: SyntheticControlDataset
    (separator=True) through the Loader at B=8, four batches, pretokenized
    on the card by the ch-160 VQVAE into four shards (the ids bit-equal to
    img_to_ids of the same batches), then TokenShardLoader feeding
    ControlVAR-d16 multi_cond with separator and type_pos (L = 1378, head
    vocab 4114) through ControlVARTrainStep(from_tokens=True): one warm-up
    and three timed steps. Returns (shard rate in samples/s, s/step, peak
    GiB, (K3, K4) a step)."""
    import glob
    import itertools

    import numpy as np

    from controlvar_tpu_torch.config import OptimConfig, VQVAEConfig
    from controlvar_tpu_torch.data.build import Loader, to_device
    from controlvar_tpu_torch.data.imagenetc import SyntheticControlDataset
    from controlvar_tpu_torch.data.shards import TokenShardLoader, pretokenize, read_token_shard
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.train.train_step import (ControlVARTrainStep, _aligned_ignore,
                                                       init_train_state, interleave_tokens)

    B, n_batches, V = 8, 4, cfg.vocab_size
    ds = SyntheticControlDataset(image_size=256, num_classes=cfg.num_classes,
                                 patch_nums=cfg.patch_nums, separator=True, length=B * n_batches)
    loader = Loader(ds, batch_size=B, seed=0, num_workers=4)
    vqvae = VQVAE(VQVAEConfig())
    vq_params = vqvae.init_params(1)
    with _scratch_dir() as d:
        pretokenize(vqvae, vq_params, loader, os.path.join(d, "warm-up"))
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = pretokenize(vqvae, vq_params, loader, os.path.join(d, "shards"))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        paths = sorted(glob.glob(os.path.join(d, "shards", "tokens_*.npz")))
        if n != n_batches or len(paths) != n_batches:
            fail(f"pretokenize: {n} shards, {len(paths)} files, expected {n_batches}")
        for path, batch in zip(paths, loader.epoch(0)):
            shard = read_token_shard(path)
            for key, img in (("ctrl_ids", "mask"), ("img_ids", "image")):
                want = vqvae.img_to_ids(vq_params, to_device(batch[img], "cuda"),
                                        compute_dtype=torch.bfloat16)
                if not all(np.array_equal(a, b.cpu().numpy()) for a, b in zip(shard[key], want)):
                    fail(f"pretokenize: {os.path.basename(path)} {key} differ from img_to_ids")
            if not np.array_equal(shard["ignore_mask"], batch["ignore_mask"]):
                fail(f"pretokenize: {os.path.basename(path)} ignore_mask differs")
        size = sum(os.path.getsize(p) for p in paths)
        print(f"pretokenize: {n} shards of B={B} ({size / 1e3:.1f} kB) in {dt:.3f} s = "
              f"{B * n / dt:.3f} samples/s (an image and its control each, bf16 ch-160 VQVAE); "
              f"read_token_shard ids equal img_to_ids of the same batches, bit for bit")
        batches = list(TokenShardLoader(os.path.join(d, "shards", "tokens_*.npz")).epoch(0))

    # the label layout and the spliced ignore mask at the separator columns
    b = to_device(batches[0], "cuda")
    labels, _ = interleave_tokens(b["ctrl_ids"], b["img_ids"],
                                  [t[..., None].float() for t in b["ctrl_ids"][1:]],
                                  [t[..., None].float() for t in b["img_ids"][1:]], True,
                                  separator=True, vocab_size=V)
    ign = _aligned_ignore(cfg, b["ignore_mask"], cfg.seq_len)
    sep_cols = [lo + pn * pn + j * (pn * pn + 1)
                for (lo, _), pn in list(zip(cfg.begin_ends, cfg.patch_nums))[1:] for j in (0, 1)]
    if labels.shape[1] != cfg.seq_len or not bool((ign[:, sep_cols] == 1).all()):
        fail("separator step: the ignore mask is not 1 at the separator columns")
    if not bool((labels[:, sep_cols] >= V).all()) or bool((labels[:, :2] >= V).any()):
        fail("separator step: the labels at the separator columns are not separator targets")
    print(f"separator step: L={cfg.seq_len}, head vocab {cfg.head_vocab}; the ignore mask is 1 "
          f"and the labels are separator targets (>= {V}) at all {len(sep_cols)} separator "
          f"columns")

    model = ControlVARModel(cfg)
    optim = OptimConfig(total_batch_size=B)
    stepper = ControlVARTrainStep(model, vqvae, optim, max_steps=1000, warmup_steps=10)
    state = init_train_state(model.init_params(0), optim)
    shard_batches, gen = itertools.cycle(batches), torch.Generator().manual_seed(13)
    expect = _launches_per_step(cfg.depth, "full")
    s_step, peak, _ = _timed_steps(
        torch, "separator/type_pos d16 from-tokens train",
        lambda: stepper.step(state, vq_params, next(shard_batches), gen, from_tokens=True)[1],
        expect, 3, B, _adaln_per_step(cfg.depth), "sep_train" if profile else None)
    return B * n / dt, s_step, peak, expect


def separator_joint_phase(torch, cfg):
    """StepwiseJointSampler on the separator/type_pos ControlVAR-d16 at B=8,
    stacked cache, AdaLN gates raised: a warm-up and a timed call (top-k
    900, top-p 0.96), then two greedy calls whose ids are equal and lie in
    [0, V). Returns (img/s, (K1, K2) a call)."""
    import controlvar_tpu_torch.eval.stepwise as stepwise
    from controlvar_tpu_torch.config import VQVAEConfig
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.ops.attention import decode_attention
    from controlvar_tpu_torch.ops.sample_kernel import sample_top_k_top_p_bisect

    B, D, S = 8, cfg.depth, cfg.num_scales
    model, vqvae = ControlVARModel(cfg), VQVAE(VQVAEConfig())
    sampler = stepwise.StepwiseJointSampler(model, vqvae)
    greedy = stepwise.StepwiseJointSampler(model, vqvae, top_k=1, top_p=0.0)
    params = sampler.prepare_params(raise_gates(model.init_params(2)))
    vq_params = vqvae.init_params(1)
    labels, cond_type = torch.arange(B) % cfg.num_classes, torch.arange(B) % 4

    def call(s, seed, decode_img=True):
        _reset(decode_attention, sample_top_k_top_p_bisect)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with recorded_draws(stepwise) as ids:
            out = s(params, vq_params, labels, cond_type, torch.Generator().manual_seed(seed),
                    decode_img=decode_img)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = (decode_attention.launches, sample_top_k_top_p_bisect.launches)
        if counts != (D * S, S):
            fail(f"separator joint: launches (K1, K2) = {counts}, expected {(D * S, S)}")
        for t_ in out:
            if not torch.isfinite(t_).all():
                fail("separator joint: non-finite output")
        if [int(x.shape[1]) for x in ids] != [cfg.scale_seg_len(si) for si in range(S)]:
            fail("separator joint: a draw is not the scale's segment")
        return dt, counts, [x.cpu() for x in ids], out

    dt_warm = call(sampler, 20)[0]
    dt, counts, ids, out = call(sampler, 21)
    for t_ in out:
        if tuple(t_.shape) != (B, 256, 256, 3) or float(t_.min()) < 0 or float(t_.max()) > 1:
            fail(f"separator joint: bad canvas {tuple(t_.shape)}")
    _, _, a, fa = call(greedy, 22, decode_img=False)
    _, _, b, fb = call(greedy, 23, decode_img=False)
    if not all(torch.equal(x, y) for x, y in zip(a, b)) or not all(
            torch.equal(x, y) for x, y in zip(fa, fb)):
        fail("separator joint: greedy ids or canvases differ between two calls")
    if not all(0 <= int(x.min()) and int(x.max()) < cfg.vocab_size for x in a + ids):
        fail("separator joint: a drawn id lies outside [0, V)")
    print(f"separator joint: warm-up call {dt_warm:.3f} s; timed call {dt:.4f} s for {B} images "
          f"= {B / dt:.3f} img/s; launches K1={counts[0]} K2={counts[1]}; greedy ids and "
          f"canvases equal over two calls, every id in [0, {cfg.vocab_size})")
    return B / dt, counts


def bidirectional_phase(torch, cfg):
    """ControlVAR-d16 bidirectional (class SOS, mask_factor 2) on a Loader
    batch (B=8, both orders' ignore masks): the loss of the two stream
    orders at the same params (they differ), then one pixel step with
    mask_first=True and one with False, K3/K4 32/16 each. Returns the two
    steps' losses."""
    import math

    from controlvar_tpu_torch.config import OptimConfig, VQVAEConfig
    from controlvar_tpu_torch.data.build import Loader, to_device
    from controlvar_tpu_torch.data.imagenetc import SyntheticControlDataset
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.ops.attention import flash_attention, flash_attention_bwd
    from controlvar_tpu_torch.train.train_step import ControlVARTrainStep, init_train_state

    B = 8
    ds = SyntheticControlDataset(image_size=256, num_classes=cfg.num_classes,
                                 patch_nums=cfg.patch_nums, length=B)
    batch = next(iter(Loader(ds, batch_size=B, seed=2, num_workers=4).epoch(0)))
    model, vqvae = ControlVARModel(cfg), VQVAE(VQVAEConfig())
    optim = OptimConfig(total_batch_size=B)
    stepper = ControlVARTrainStep(model, vqvae, optim, max_steps=1000, warmup_steps=10)
    state = init_train_state(model.init_params(0), optim)
    vq_params = vqvae.init_params(1)
    with torch.no_grad():
        both = [float(stepper.loss_fn(state.params, vq_params, to_device(batch, "cuda"), None,
                                      mf)[0]) for mf in (True, False)]
    if not all(map(math.isfinite, both)) or both[0] == both[1]:
        fail(f"bidirectional: the two orders' losses at the same params are {both}")
    gen, losses = torch.Generator().manual_seed(14), []
    for mask_first in (True, False):
        _reset(flash_attention, flash_attention_bwd)
        _, aux = stepper.step(state, vq_params, batch, gen, mask_first=mask_first)
        counts = (flash_attention.launches, flash_attention_bwd.launches)
        losses.append(float(aux["loss"]))
        if counts != _launches_per_step(cfg.depth, "full") or not math.isfinite(losses[-1]):
            fail(f"bidirectional: step mask_first={mask_first}: launches {counts}, loss "
                 f"{losses[-1]}")
    if losses[0] == losses[1]:
        fail("bidirectional: the two steps' losses are equal")
    print(f"bidirectional: losses at the same params {both[0]:.5f} (mask first) / {both[1]:.5f} "
          f"(image first); steps {losses[0]:.5f} (mask_first=True) then {losses[1]:.5f} "
          f"(False), K3/K4 {counts[0]}/{counts[1]} a step")
    return losses


def cond_model_phase(torch, cfg):
    """ControlVARModel.sample_cond_cfg against StepwiseCondSampler on the
    same inputs: ControlVAR-d16 multi_cond, AdaLN gates raised, B=16,
    force="control" with random per-scale control ids, greedy, for
    repeat_num 4 and 3; every draw's ids and the canvases bit-equal, K1
    160 and K2 10 a call in each."""
    import controlvar_tpu_torch.eval.stepwise as stepwise
    import controlvar_tpu_torch.models.control_var as control_var
    from controlvar_tpu_torch.config import VQVAEConfig
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.ops.attention import decode_attention
    from controlvar_tpu_torch.ops.sample_kernel import sample_top_k_top_p_bisect

    B, D, S = 16, cfg.depth, cfg.num_scales
    model, vqvae = ControlVARModel(cfg), VQVAE(VQVAEConfig())
    g = torch.Generator().manual_seed(21)
    labels = torch.randint(0, cfg.num_classes, (B,), generator=g)
    cond_type = torch.randint(0, 4, (B,), generator=g)
    forced = [torch.randint(0, cfg.vocab_size, (B, pn * pn), generator=g).cuda()
              for pn in cfg.patch_nums]
    vq_params = vqvae.init_params(1)
    params = None
    for R in (4, 3):
        sampler = stepwise.StepwiseCondSampler(model, vqvae, top_k=1, top_p=0.0, repeat_num=R)
        if params is None:
            params = sampler.prepare_params(raise_gates(model.init_params(3)))
        runs = {}
        for name, fn in (
                ("sample_cond_cfg", lambda: model.sample_cond_cfg(
                    params, vqvae, vq_params, labels, cond_type, torch.Generator().manual_seed(5),
                    c_mask=forced, top_k=1, top_p=0.0, repeat_num=R, decode_img=False)),
                ("StepwiseCondSampler", lambda: sampler(
                    params, vq_params, labels, cond_type, torch.Generator().manual_seed(5),
                    forced, decode_img=False))):
            _reset(decode_attention, sample_top_k_top_p_bisect)
            torch.cuda.synchronize()
            t = time.perf_counter()
            with recorded_draws(control_var, stepwise) as ids:
                out = fn()
            torch.cuda.synchronize()
            counts = (decode_attention.launches, sample_top_k_top_p_bisect.launches)
            if counts != (D * S, S):
                fail(f"{name}, repeat_num {R}: launches (K1, K2) = {counts}")
            runs[name] = (ids, out, time.perf_counter() - t)
        (ids_m, out_m, dt_m), (ids_s, out_s, dt_s) = runs.values()
        if len(ids_m) != S or not all(torch.equal(a, b) for a, b in zip(ids_m, ids_s)):
            fail(f"sample_cond_cfg, repeat_num {R}: ids differ from StepwiseCondSampler's")
        if not all(torch.equal(a, b) for a, b in zip(out_m, out_s)):
            fail(f"sample_cond_cfg, repeat_num {R}: canvases differ from StepwiseCondSampler's")
        print(f"sample_cond_cfg, repeat_num {R}, B={B}, force control, greedy: ids of all {S} "
              f"draws and both f_hats bit-equal to StepwiseCondSampler's ({dt_m:.3f} s / "
              f"{dt_s:.3f} s a call); launches K1={D * S} K2={S} a call")


def shared_aln_phase(torch, cfg):
    """VAR-d16 with shared_aln: StepwiseVARSampler at B=16 (AdaLN gates
    raised; a warm-up and a timed call, K1 160 and K2 10 a call) and a
    VARTrainStep at B=8 (a warm-up and a timed step, K3/K4 32/16). Returns
    (img/s, s/step)."""
    from controlvar_tpu_torch.config import OptimConfig, VQVAEConfig
    from controlvar_tpu_torch.eval.stepwise import StepwiseVARSampler
    from controlvar_tpu_torch.models.var import VARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.ops.attention import decode_attention
    from controlvar_tpu_torch.ops.sample_kernel import sample_top_k_top_p_bisect
    from controlvar_tpu_torch.train.train_step import VARTrainStep, init_train_state

    B, D, S = 16, cfg.depth, cfg.num_scales
    model, vqvae = VARModel(cfg), VQVAE(VQVAEConfig())
    vq_params = vqvae.init_params(1)
    sampler = StepwiseVARSampler(model, vqvae, cfg_scale=1.5, top_k=900, top_p=0.96)
    params = sampler.prepare_params(raise_gates(model.init_params(0)))
    labels = torch.arange(B) % cfg.num_classes
    dts = []
    for seed in (30, 31):
        _reset(decode_attention, sample_top_k_top_p_bisect)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = sampler(params, vq_params, labels, torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t)
        counts = (decode_attention.launches, sample_top_k_top_p_bisect.launches)
        if counts != (D * S, S):
            fail(f"shared_aln VAR-d16 sampler: launches (K1, K2) = {counts}")
        if tuple(out.shape) != (B, 256, 256, 3) or not torch.isfinite(out).all():
            fail(f"shared_aln VAR-d16 sampler: bad images {tuple(out.shape)}")
    print(f"shared_aln VAR-d16 sampler: warm-up call {dts[0]:.3f} s; timed call {dts[1]:.4f} s "
          f"for {B} images = {B / dts[1]:.3f} img/s; launches K1={D * S} K2={S}")
    del params
    optim = OptimConfig(total_batch_size=8)
    stepper = VARTrainStep(model, vqvae, optim, max_steps=1000, warmup_steps=10)
    state = init_train_state(model.init_params(4), optim)
    batch = _pixel_batch(torch, 8, cfg.num_classes, 17, control=False)
    gen = torch.Generator().manual_seed(18)
    s_step, _, _ = _timed_steps(torch, "shared_aln VAR-d16 train",
                                lambda: stepper.step(state, vq_params, batch, gen)[1],
                                _launches_per_step(D, "full"), 1, 8, _adaln_per_step(D))
    return B / dts[1], s_step


# kernel-name substrings of each device-time category, tested in this order:
# K5 runs K1's kernel body under its own name, matched before K1/K8's
CATEGORIES = (("K5 prefix decode", ("decode_attention_prefix_kernel",)),
              ("K1/K8 decode attention", ("decode_attention_kernel",)),
              ("K7 flat decode attention", ("decode_flat_kernel",)),
              ("K6 in-place decode", ("decode_inplace_kernel",)),
              ("K2 sampling", ("sample_bisect_kernel",)),
              ("K3 flash attention", ("flash_fwd_kernel",)),
              ("K4 flash attention backward", ("flash_bwd_",)),
              ("convolution", ("fprop", "dgrad", "wgrad", "conv", "cudnn", "nchwToNhwc",
                               "nhwcToNchw")),
              ("matmul", ("gemm", "nvjet", "cutlass", "xmma")),
              ("copy and cast", ("copy", "Memcpy", "Memset")),
              ("elementwise", ("elementwise",)),
              ("reduction and norm", ("reduce", "Moments", "norm", "softmax")))


def _tree_max_diff(torch, a, b) -> float:
    """The largest |a - b| over two trees' leaves (same names)."""
    from controlvar_tpu_torch.train.param_groups import named_leaves

    la, lb = dict(named_leaves(a)), dict(named_leaves(b))
    if sorted(la) != sorted(lb):
        fail(f"trees differ in their leaves: {sorted(set(la) ^ set(lb))}")
    return max(float((la[k].detach().float() - lb[k].detach().float()).abs().max()) for k in la)


def _clone_tree(tree):
    from controlvar_tpu_torch.device import tree_map

    return tree_map(lambda t: t.detach().clone(), tree)


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def trainer_phase(torch, cfg, vq_cfg, B=8, device="cuda"):
    """The Trainer loop on a from-tokens ControlVAR (the card: d16 multi_cond
    separator/type_pos, B=8): four shards written by pretokenize from
    synthetic Loader batches, TokenShardLoader, optim.epochs=2 (8 steps).
    Two uninterrupted runs to stop_after=6 (their params compared for the
    run-to-run spread; the second timed, K3/K4 counted), a run stopped at
    step 3 (mid-epoch 0) with its checkpoint, and a fresh Trainer that
    resumes it to step 6 across the epoch boundary: its params must equal
    the uninterrupted run's bit for bit when the two uninterrupted runs are
    bit-equal, else lie within twice their spread. Every CheckpointIO.save
    is timed. Then one more step inside a world-size-1 process group (NCCL;
    gloo on the CPU), through the gradient average's one all-reduce,
    bit-equal to the same step without a group. Returns (s/step, save
    seconds, spread, (K3, K4) a step)."""
    import copy as copy_module
    import math
    import socket

    import torch.distributed as dist

    from controlvar_tpu_torch.ckpt import orbax_io
    from controlvar_tpu_torch.config import OptimConfig
    from controlvar_tpu_torch.data.build import Loader
    from controlvar_tpu_torch.data.imagenetc import SyntheticControlDataset
    from controlvar_tpu_torch.data.shards import TokenShardLoader, pretokenize, read_token_shard
    from controlvar_tpu_torch.device import generator_for
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.ops.attention import flash_attention, flash_attention_bwd
    from controlvar_tpu_torch.parallel import distributed
    from controlvar_tpu_torch.train.param_groups import named_leaves
    from controlvar_tpu_torch.train.train_step import init_train_state
    from controlvar_tpu_torch.train.trainer import Trainer

    vqvae = VQVAE(vq_cfg, device=device)
    vq_params = vqvae.init_params(1)
    ds = SyntheticControlDataset(image_size=cfg.patch_nums[-1] * 16, num_classes=cfg.num_classes,
                                 patch_nums=cfg.patch_nums, separator=cfg.separator,
                                 length=B * 4)
    params0 = ControlVARModel(cfg, device=device).init_params(0)
    saves, real_save = [], orbax_io.CheckpointIO.save

    def timed_save(self, step, state, metadata=None):
        _sync(torch, device)
        t = time.perf_counter()
        real_save(self, step, state, metadata)
        saves.append(time.perf_counter() - t)

    with _scratch_dir() as d:
        pretokenize(vqvae, vq_params, Loader(ds, batch_size=B, seed=0, num_workers=4),
                    os.path.join(d, "shards"), compute_dtype=(
                        torch.bfloat16 if device == "cuda" else torch.float32))
        pattern = os.path.join(d, "shards", "tokens_*.npz")
        extra_batch = read_token_shard(sorted(glob.glob(pattern))[0])

        def trainer(stop_after, ckpt=None, logs=None):
            return Trainer(cfg, vq_cfg, OptimConfig(total_batch_size=B, epochs=2),
                           TokenShardLoader(pattern), vq_params, from_tokens=True,
                           stop_after=stop_after, log_every=1,
                           ckpt_dir=None if ckpt is None else os.path.join(d, ckpt),
                           log_fn=logs.append if logs is not None else (lambda m: None),
                           device=device)

        orbax_io.CheckpointIO.save = timed_save
        try:
            tr = trainer(6)
            u1_params = _clone_tree(tr.fit(tr.init_state(base_params=_clone_tree(params0))).params)
            _reset(flash_attention, flash_attention_bwd)
            logs = []
            tr = trainer(6, logs=logs)
            state0 = tr.init_state(base_params=_clone_tree(params0))
            _sync(torch, device)
            t = time.perf_counter()
            u2 = tr.fit(state0)
            _sync(torch, device)
            s_step = (time.perf_counter() - t) / 6
            counts = (flash_attention.launches, flash_attention_bwd.launches)
            spread = _tree_max_diff(torch, u2.params, u1_params)
            del u1_params, state0
            first = trainer(3, "ckpt")
            first.fit(first.init_state(base_params=_clone_tree(params0)))
            del first
            resumed_logs = []
            second = trainer(6, "ckpt", resumed_logs)
            state, epoch = second.maybe_resume(
                second.init_state(base_params=_clone_tree(params0)))
            if (state.step, epoch) != (3, 0):  # the epoch recorded at the mid-epoch stop
                fail(f"trainer: resumed at step {state.step}, epoch {epoch}")
            resumed = second.fit(state, epoch)
        finally:
            orbax_io.CheckpointIO.save = real_save
    del params0
    order = [(m["step"], m["epoch"]) for m in resumed_logs]
    if order != [(3, 0), (4, 1), (5, 1)] or resumed.step != 6:
        fail(f"trainer: the resumed run took steps {order}, ended at {resumed.step}")
    if not all(math.isfinite(m["loss"]) for m in logs + resumed_logs):
        fail("trainer: a non-finite loss")
    diff = _tree_max_diff(torch, resumed.params, u2.params)
    print(f"trainer: two uninterrupted runs of 6 steps differ by {spread:.3e} (largest |param "
          f"difference|); the run stopped at step 3 and resumed by a fresh Trainer across the "
          f"epoch boundary to step 6 differs from the uninterrupted one by {diff:.3e}")
    if diff > 2 * spread:
        fail(f"trainer: the resumed params differ by {diff:.3e} > twice the spread {spread:.3e}")
    if torch.device(device).type == "cuda" and counts != (6 * 2 * cfg.depth, 6 * cfg.depth):
        fail(f"trainer: 6 steps launched (K3, K4) = {counts}")
    n_params = sum(p.numel() for _, p in named_leaves(u2.params))
    print(f"trainer: {s_step:.4f} s/step over the 6 steps of an uninterrupted Trainer.fit "
          f"(B={B}, from tokens; logged sec_per_step "
          + ", ".join(f"{m['sec_per_step']:.4f}" for m in logs)
          + f"), K3/K4 {counts[0]}/{counts[1]}; CheckpointIO.save of the state ({n_params / 1e6:.1f} "
          f"M params with their AdamW moments): " + ", ".join(f"{s:.3f}" for s in saves) + " s")
    del resumed, second, state

    # one more step, without a group and inside a world-size-1 group
    copy = init_train_state(_clone_tree(u2.params), tr.optim)
    # a deep copy: load_state_dict keeps the state's step tensors, which
    # AdamW increments in place
    copy.optimizer.load_state_dict(copy_module.deepcopy(u2.optimizer.state_dict()))
    copy.step = u2.step
    tr.stepper.step(copy, tr.vq_params, extra_batch, generator_for(6), from_tokens=True)
    reduces, real_all_reduce = [], dist.all_reduce

    def counted(t, *args, **kwargs):
        reduces.append(t.numel())
        return real_all_reduce(t, *args, **kwargs)

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    distributed.initialize(f"localhost:{port}", 1, 0, device=device)
    dist.all_reduce = counted
    try:
        tr.stepper.step(u2, tr.vq_params, extra_batch, generator_for(6), from_tokens=True)
    finally:
        dist.all_reduce = real_all_reduce
        distributed.shutdown()
    if reduces != [n_params] or dist.is_initialized():
        fail(f"trainer: the group step all-reduced {reduces}, not one buffer of {n_params}")
    group_diff = _tree_max_diff(torch, copy.params, u2.params)
    print(f"trainer: a step inside a world-size-1 "
          f"{'NCCL' if torch.device(device).type == 'cuda' else 'gloo'} group (one all-reduce "
          f"of the {n_params} gradients) differs from the same step without a group by "
          f"{group_diff:.3e}")
    if group_diff != 0.0:
        fail("trainer: the world-size-1 group step is not bit-equal to the step without one")
    return s_step, saves, spread, (counts[0] // 6, counts[1] // 6)


def _gan_batch(torch, B, image_size, seed, device):
    """B seeded image/mask pairs in [-1, 1] from SyntheticControlDataset
    through the Loader, on `device`."""
    from controlvar_tpu_torch.data.build import Loader, to_device
    from controlvar_tpu_torch.data.imagenetc import SyntheticControlDataset

    ds = SyntheticControlDataset(image_size=image_size, num_classes=10, length=B)
    batch = next(iter(Loader(ds, batch_size=B, seed=seed, num_workers=4).epoch(0)))
    return to_device(batch["image"], device), to_device(batch["mask"], device)


def tokenizer_phase(torch, vq_cfg, B=8, device="cuda"):
    """Tokenizer training at full width (the card: the ch-160 VQVAE, z 32,
    256x256, fp32 as the JAX package trains it, random LPIPS and
    discriminator weights, train-vqvae's lr 1e-4): MaskVQVAETrainStep G
    then D steps on one repeated synthetic image/mask batch, one warm-up
    and three timed (s/step, peak memory): every loss finite, usage_pct in
    (0, 100], the nll falling at every timed step and after the last one
    (the warm-up step's first Adam update lifts it). The GAN terms are
    gated (disc_start past the steps, as the JAX package's own
    nll-decrease test runs; the D steps run their gated loss): with
    disc_start 0 the adaptive-weighted GAN term of a random discriminator
    makes the nll of these first steps oscillate (0.6160, 0.8141, 0.7291,
    0.6333 before the four steps of one run, H100 80GB HBM3 at 700 W). Then the
    DualGANTrainState through CheckpointIO into a fresh state, bit for bit,
    and one VQVAETrainStep G + D step with disc_start 0 (every term, d_loss
    > 0). Returns (s/step, peak GiB, the nll before each step and after the
    last)."""
    import math

    from controlvar_tpu_torch.ckpt.orbax_io import CheckpointIO
    from controlvar_tpu_torch.losses.vqperceptual import VQLPIPSWithDiscriminator
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.models.vqvae_mask import MaskVQVAE
    from controlvar_tpu_torch.train.param_groups import named_leaves
    from controlvar_tpu_torch.train.train_vqvae import MaskVQVAETrainStep, VQVAETrainStep

    images, masks = _gan_batch(torch, B, vq_cfg.patch_nums[-1] * 16, 3, device)
    loss = VQLPIPSWithDiscriminator(disc_start=1000)
    step = MaskVQVAETrainStep(MaskVQVAE(vq_cfg, device=device), loss, lr=1e-4)
    state, lpips_params = step.init_state(0)
    n_vq = sum(p.numel() for _, p in named_leaves(state.vq_params))
    n_disc = sum(p.numel() for _, p in named_leaves(state.disc_params))
    nlls, times = [], []

    def one():
        nonlocal state
        _sync(torch, device)
        t = time.perf_counter()
        state, gm, (ri, rm) = step.g_step(state, lpips_params, images, masks)
        state, dm = step.d_step(state, images, masks, ri, rm)
        _sync(torch, device)
        times.append(time.perf_counter() - t)
        metrics = {k: float(v) for k, v in {**gm, **dm}.items()}
        if not all(math.isfinite(v) for v in metrics.values()):
            fail(f"tokenizer: a non-finite metric: {metrics}")
        if not 0.0 < metrics["usage_pct"] <= 100.0 or not 0.0 < metrics["mask_usage_pct"] <= 100:
            fail(f"tokenizer: usage_pct {metrics['usage_pct']}, mask_usage_pct "
                 f"{metrics['mask_usage_pct']}")
        nlls.append(metrics["nll"])
        return metrics

    m = one()
    print(f"tokenizer: MaskVQVAE {n_vq / 1e6:.2f} M params, discriminator {n_disc / 1e6:.2f} M; "
          f"warm-up G+D step {times[0]:.3f} s: " + ", ".join(f"{k} {v:.5g}" for k, v in m.items()))
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        m = one()
    s_step = sum(times[1:]) / 3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if device == "cuda" else 0.0
    print(f"tokenizer: MaskVQVAETrainStep G+D at B={B}: timed steps "
          + ", ".join(f"{t:.4f}" for t in times[1:]) + f" s, mean {s_step:.4f} s/step; peak "
          f"memory {peak:.2f} GiB; nll " + ", ".join(f"{x:.6f}" for x in nlls)
          + f"; last step: d_loss {m['d_loss']:.5f}, d_weight {m['d_weight']:.5f}, usage "
          f"{m['usage_pct']:.2f}% / mask {m['mask_usage_pct']:.2f}%")
    with torch.no_grad():
        ri, rm, _, mvq, vq = step.vqvae.forward_train_joint(state.vq_params, images, masks)
        nlls.append(float(loss.generator_loss_dual(lpips_params, state.disc_params, images,
                                                   masks, ri, rm, vq, mvq, state.step)[1]["nll"]))
    print(f"tokenizer: nll after the last step {nlls[-1]:.6f}")
    # the warm-up step's Adam update is about lr * sign(g) on every one of the
    # 109 M params, which lifts the nll; it must fall from there on
    if not all(a > b for a, b in zip(nlls[1:], nlls[2:])):
        fail(f"tokenizer: the nll did not fall over the timed steps: {nlls}")

    with _scratch_dir() as d:
        io = CheckpointIO(d)
        _sync(torch, device)
        t = time.perf_counter()
        io.save(state.step, state, metadata={"epoch": 0})
        t_save = time.perf_counter() - t
        fresh, _ = step.init_state(1)
        restored, meta = io.restore(fresh)
    for field in ("vq_params", "disc_params", "usage", "mask_usage"):
        if _tree_max_diff(torch, getattr(restored, field), getattr(state, field)) != 0.0:
            fail(f"tokenizer: checkpoint round trip changed {field}")
    for opt in ("vq_opt", "disc_opt"):
        a, b = getattr(restored, opt).state_dict()["state"], getattr(state, opt).state_dict()[
            "state"]
        if a.keys() != b.keys() or not all(torch.equal(a[i][k], b[i][k]) for i in a
                                           for k in ("exp_avg", "exp_avg_sq", "step")):
            fail(f"tokenizer: checkpoint round trip changed {opt}")
    if restored.step != state.step or meta != {"epoch": 0}:
        fail(f"tokenizer: restored step {restored.step}, metadata {meta}")
    print(f"tokenizer: DualGANTrainState saved ({t_save:.3f} s) and restored into a fresh state "
          f"bit for bit (both trees, both Adam states, step {restored.step}, both usage EMAs)")
    del state, restored, fresh

    single = VQVAETrainStep(VQVAE(vq_cfg, device=device),
                            VQLPIPSWithDiscriminator(disc_start=0), lr=1e-4)
    state, lpips_params = single.init_state(2)
    state, gm = single.g_step(state, lpips_params, images)
    state, dm = single.d_step(state, images)
    metrics = {k: float(v) for k, v in {**gm, **dm}.items()}
    if (not all(math.isfinite(v) for v in metrics.values()) or state.step != 1
            or not metrics["d_loss"] > 0.0):
        fail(f"tokenizer: VQVAETrainStep G+D: {metrics}, step {state.step}")
    print("tokenizer: VQVAETrainStep G+D step: " + ", ".join(
        f"{k} {v:.5g}" for k, v in metrics.items()))
    return s_step, peak, nlls


def tokenizer_reference(torch, devices=("cpu", "cuda")):
    """A tiny MaskVQVAETrainStep G + D step (ch 32, patch_nums (1, 2, 4),
    V 64, B=2 at 64x64, the CPU tests' size) on the card against the CPU,
    fp32 with TF32 off on both: the image ids, both codebooks' hit counts
    equal; the metrics within 1e-4 relative (the adaptive weight within
    2e-3: ~1e-4 reconstruction differences move a few discriminator
    pre-activations across LeakyReLU's kink); each gradient leaf within a
    relative L2 error of 2e-3 plus 1e-6 of the tree's largest gradient; the
    params after Adam within lr 1e-2 where the gradient is clear of that
    noise, within Adam's own bound 2 lr elsewhere. The G step's GAN term is
    gated (disc_start past the step), the D step ungated on the CPU's
    reconstructions."""
    import math

    from controlvar_tpu_torch.config import VQVAEConfig
    from controlvar_tpu_torch.device import no_tf32
    from controlvar_tpu_torch.losses.vqperceptual import VQLPIPSWithDiscriminator
    from controlvar_tpu_torch.models.vqvae_mask import MaskVQVAE
    from controlvar_tpu_torch.train.param_groups import named_leaves
    from controlvar_tpu_torch.train.train_vqvae import MaskVQVAETrainStep

    lr, vq_cfg = 1e-4, VQVAEConfig(ch=32, patch_nums=(1, 2, 4), vocab_size=64)
    g = torch.Generator().manual_seed(4)
    img, msk = (torch.rand(2, 64, 64, 3, generator=g) * 2 - 1 for _ in range(2))
    out = {}
    for i, device in enumerate(devices):
        vq = MaskVQVAE(vq_cfg, device=device)
        g_step = MaskVQVAETrainStep(vq, VQLPIPSWithDiscriminator(disc_start=1000), lr=lr)
        d_step = MaskVQVAETrainStep(vq, VQLPIPSWithDiscriminator(disc_start=0), lr=lr)
        with no_tf32():
            state, lp = g_step.init_state(0)
            ids = vq.img_to_ids(state.vq_params, img.to(device))
            state, gm, (ri, rm) = g_step.g_step(state, lp, img, msk)
            grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).double().cpu()
                     for n, p in named_leaves(state.vq_params)}
            recon = out[0]["recon"] if i else (ri, rm)
            state, dm = d_step.d_step(state, img, msk, *(t.to(device) for t in recon))
            grads.update({f"disc/{n}": p.grad.double().cpu()
                          for n, p in named_leaves(state.disc_params)})
        out[i] = dict(
            ids=[t.cpu() for t in ids], recon=(ri.cpu(), rm.cpu()), grads=grads,
            metrics={k: float(v) for k, v in {**gm, **dm}.items()},
            hits=(state.usage["ema_hits"].cpu(), state.mask_usage["ema_hits"].cpu()),
            params={**{n: p.detach().double().cpu() for n, p in named_leaves(state.vq_params)},
                    **{f"disc/{n}": p.detach().double().cpu()
                       for n, p in named_leaves(state.disc_params)}})
    c, k = out[0], out[1]
    if not all(torch.equal(a, b) for a, b in zip(c["ids"], k["ids"])):
        fail("tokenizer reference: the card's image ids differ from the CPU's")
    if not all(torch.equal(a, b) for a, b in zip(c["hits"], k["hits"])):
        fail("tokenizer reference: the card's codebook hit counts differ from the CPU's")
    worst_metric = 0.0
    for name, want in c["metrics"].items():
        rel = abs(k["metrics"][name] - want) / max(abs(want), 1e-6)
        worst_metric = max(worst_metric, rel if name != "d_weight" else 0.0)
        if rel > (2e-3 if name == "d_weight" else 1e-4):
            fail(f"tokenizer reference: {name} {k['metrics'][name]} vs the CPU's {want}")
    worst_l2, worst_param = 0.0, 0.0
    for tree in ("vq", "disc"):
        names = [n for n in c["grads"] if n.startswith("disc/") == (tree == "disc")]
        floor = 1e-6 * max(float(c["grads"][n].abs().max()) for n in names)
        for n in names:
            want, got = c["grads"][n], k["grads"][n]
            err = (got - want).abs()
            l2, l2_want = float(err.norm()), float(want.norm())
            if l2 > 2e-3 * l2_want + floor * math.sqrt(err.numel()):
                fail(f"tokenizer reference: gradient of {n}: L2 error {l2:.3e} of {l2_want:.3e}")
            if l2_want > floor * math.sqrt(err.numel()):
                worst_l2 = max(worst_l2, l2 / l2_want)
            diff = (k["params"][n] - c["params"][n]).abs()
            clear = want.abs() > max(1e-2 * float(want.abs().max()), 1e2 * floor)
            if bool((diff[clear] > lr * 1e-2).any()) or float(diff.max()) > 2 * lr * (1 + 1e-5):
                fail(f"tokenizer reference: param {n} after Adam differs by {float(diff.max()):.3e}")
            if bool(clear.any()):
                worst_param = max(worst_param, float(diff[clear].max()))
    print(f"tokenizer reference: tiny MaskVQVAE G+D step, fp32 without TF32, card vs CPU: ids "
          f"and hit counts equal; largest metric relative difference {worst_metric:.3e} "
          f"(d_weight {abs(k['metrics']['d_weight'] - c['metrics']['d_weight']) / c['metrics']['d_weight']:.3e}); "
          f"largest gradient relative L2 error {worst_l2:.3e}; largest param difference where "
          f"the gradient is clear of the noise {worst_param:.3e} (lr {lr:g})")


# ---- tensor parallelism: two ranks on this one card --------------------------

# The tensor-parallel run (model=2, bf16 on the card) against the same call or
# step on one device, both from the same seeds. Serving: the ranks' draws are
# replaced by the one-device call's ids, so both sides see the same inputs at
# every scale, and the CFG-combined logits of scales 1 and 9 are held to a
# relative L2 error of 2^-5: the row-parallel sums round each rank's bf16
# partial product before an fp32 sum where the one-device product rounds the
# whole sum once, ~2^-9 relative each, compounded over 16 layers and the
# final LayerNorm (~2^-7 expected), with a factor 4 of room. Training: the
# loss within 2^-8 relative (TRAIN_LOSS_RTOL), grad_norm within 2^-6, the
# clipped gradient's cosine (whole and per block leaf) >= 0.999
# (TRAIN_GRAD_COS), and every param after the step within 2 lr of the
# one-device step's plus two fp32 ulps: AdamW's first step moves a param by
# lr m/(sqrt(v) + eps), at most lr either way, so a gradient element that
# bf16 noise flips may move it 2 lr apart and nothing else may.
TP_LOGIT_REL_L2 = 2.0 ** -5
TP_GRAD_NORM_RTOL = 2.0 ** -6
TP_CALL_TIMEOUT_S = 400


def _tp_models(torch, cfg, mesh):
    """The d16 multi_cond model (tensor parallel on `mesh`), the ch-160
    VQVAE and their params from seeds: gates raised, this rank's shard."""
    from controlvar_tpu_torch.config import VQVAEConfig
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.parallel.tensor import shard_params

    model, vqvae = ControlVARModel(cfg, mesh=mesh), VQVAE(VQVAEConfig())
    params = raise_gates(model.init_params(0))
    if model.tp is not None:
        params = shard_params(mesh, params, mesh.model_index, cfg)
    return model, vqvae, params, vqvae.init_params(1)


def _tp_serving_inputs(torch, cfg, B=16):
    g = torch.Generator().manual_seed(3)
    labels = torch.randint(0, cfg.num_classes, (B,), generator=g)
    cond_type = torch.randint(0, 4, (B,), generator=g)
    imgs = (torch.rand(B, 256, 256, 3, generator=g) * 2 - 1).cuda()
    return labels, cond_type, imgs


@contextlib.contextmanager
def _tp_recorded(torch, forced=None, branches=None):
    """(ids of every draw after the model group's broadcast, {scale: the
    CFG-combined logits of scales 1 and 9}); with `forced`, each draw is
    replaced by forced[scale]; with a dict `branches`, each CFG branch's
    own logits at those scales (`head_logits` of every row, cut to the
    vocabulary) go into it."""
    from controlvar_tpu_torch.eval import stepwise
    from controlvar_tpu_torch.models import transformer as tfm

    ids, logits = [], {}
    draw, head = stepwise.tp_draw, tfm.head_logits_cfg

    def spy_draw(x, tp):
        out = draw(x, tp)
        if forced is not None:
            out = forced[len(ids)].to(out.device)
        ids.append(out)
        return out

    def spy_head(*args, **kwargs):
        out = head(*args, **kwargs)
        if len(ids) in (1, 9):
            V = args[3].vocab_size
            logits[len(ids)] = out[..., :V].detach().clone()
            if branches is not None:
                tp = args[5] if len(args) > 5 else kwargs.get("tp")
                branches[len(ids)] = tfm.head_logits(*args[:4], tp)[..., :V].detach().clone()
        return out

    stepwise.tp_draw, tfm.head_logits_cfg = spy_draw, spy_head
    try:
        yield ids, logits
    finally:
        stepwise.tp_draw, tfm.head_logits_cfg = draw, head


def _tp_train_step(torch, cfg, model, vqvae, params, vq_params):
    """The training path's step (B=8, d16 multi_cond, AdamW) on `params`:
    (stepper, state, batch, generator seed)."""
    from controlvar_tpu_torch.config import OptimConfig
    from controlvar_tpu_torch.train.train_step import ControlVARTrainStep, init_train_state

    optim = OptimConfig(total_batch_size=8)
    stepper = ControlVARTrainStep(model, vqvae, optim, max_steps=1000, warmup_steps=10)
    return stepper, init_train_state(params, optim), _pixel_batch(torch, 8, cfg.num_classes, 5)


def _tp_step_limits(torch, label, one, tp, names=None):
    """A tensor-parallel step (loss, grad_norm, lr, {name: param after},
    {name: clipped gradient}, whole trees on the card) against the
    one-device step's: the limits above; `names` (default: the block
    leaves) are also held to TRAIN_GRAD_COS one by one. Returns the printed
    summary dict."""
    loss, norm, lr, params, grads = one
    t_loss, t_norm, _, t_params, t_grads = tp
    cosine = lambda a, b: float((a.double() @ b.double()) / (a.double().norm() * b.double().norm()))
    flat = lambda g: torch.cat([g[k].reshape(-1).float() for k in sorted(g)])
    rel = abs(t_loss - loss) / abs(loss)
    rel_norm = abs(t_norm - norm) / norm
    cos = cosine(flat(t_grads), flat(grads))
    names = names or [k for k in grads if k.startswith("blocks/")]
    leaf_cos = {k: cosine(t_grads[k].reshape(-1), grads[k].reshape(-1)) for k in names}
    worst = min(leaf_cos, key=leaf_cos.get)
    excess = max(float(((t_params[k] - v).abs() - (2 * lr + 2.0 ** -22 * v.abs())).max())
                 for k, v in params.items())
    print(f"{label}: loss {t_loss:.6f} vs {loss:.6f} one device (relative {rel:.3e}), "
          f"grad_norm {t_norm:.6f} vs {norm:.6f} (relative {rel_norm:.3e}), gradient cosine "
          f"{cos:.6f}, worst leaf {worst} {leaf_cos[worst]:.6f}, params after the step: "
          f"largest |diff| - (2 lr + 2 ulp) = {excess:.3e} (lr {lr:.3e})", flush=True)
    if not (rel <= TRAIN_LOSS_RTOL and rel_norm <= TP_GRAD_NORM_RTOL and cos >= TRAIN_GRAD_COS
            and leaf_cos[worst] >= TRAIN_GRAD_COS and excess <= 0.0):
        fail(f"{label}: outside the limits against the one-device step")
    return dict(loss_rel=rel, grad_norm_rel=rel_norm, cos=cos, worst=worst,
                worst_cos=leaf_cos[worst])


def tp_rank_main(rank: int, port: str, port_cli: str, directory: str) -> None:
    """One rank of the tensor-parallel phase (`python3 chip_smoke.py
    --tp-rank RANK PORT PORT_CLI DIR`): a gloo group of two on this card,
    make_mesh(model=2), the d16 north-star call (a warm-up, a timed call
    with K1/K2 counted, a call on the one-device run's ids whose logits it
    holds to that run's), the train step (a compared step with K3/K4
    counted, two timed), then `cli.main train --model_axis 2` for one step
    on a second group. Writes DIR/rank<RANK>.json and .pt."""
    import math

    import torch

    from controlvar_tpu_torch.config import SampleConfig, control_var_config_from_depth
    from controlvar_tpu_torch.device import tree_map
    from controlvar_tpu_torch.eval.harness import SamplingHarness
    from controlvar_tpu_torch.ops.attention import (decode_attention, flash_attention,
                                                    flash_attention_bwd)
    from controlvar_tpu_torch.ops.sample_kernel import sample_top_k_top_p_bisect
    from controlvar_tpu_torch.parallel import distributed
    from controlvar_tpu_torch.parallel.mesh import make_mesh
    from controlvar_tpu_torch.parallel.tensor import gather_params

    kernels = (decode_attention, sample_top_k_top_p_bisect, flash_attention, flash_attention_bwd)
    cfg = control_var_config_from_depth(16, multi_cond=True)
    distributed.initialize(f"localhost:{port}", 2, rank, backend="gloo")
    mesh = make_mesh(model=2)
    res = {"rank": rank, "mesh": [mesh.data, mesh.model, mesh.data_index, mesh.model_index]}
    model, vqvae, params, vq_params = _tp_models(torch, cfg, mesh)
    res["heads"] = params["blocks"]["qkv_kernel"].shape[-1] // (3 * cfg.head_dim)
    harness = SamplingHarness(model, vqvae, SampleConfig())
    serve_params = harness.prepare_params(params)
    labels, cond_type, imgs = _tp_serving_inputs(torch, cfg)

    def call(seed, forced=None):
        _reset(*kernels)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with _tp_recorded(torch, forced) as (ids, logits):
            out = harness.control_conditioned(serve_params, vq_params, labels, cond_type,
                                              torch.Generator().manual_seed(seed), imgs)
        torch.cuda.synchronize()
        return time.perf_counter() - t, ids, logits, out, [k.launches for k in kernels[:2]]

    res["serve_warmup_s"] = call(10)[0]
    dt, ids, _, out, counts = call(11 + rank)  # the ranks' generators differ
    res.update(serve_s=dt, serve_counts=counts,
               canvases_ok=all(tuple(t.shape) == (16, 256, 256, 3) and bool(torch.isfinite(t).all())
                               and float(t.min()) >= 0.0 and float(t.max()) <= 1.0 for t in out))
    ref = torch.load(os.path.join(directory, "serve_ref.pt"), weights_only=True)
    _, _, logits, _, _ = call(11, forced=ref["ids"])
    res["logits"] = {}
    for si, want in ref["logits"].items():
        got, want = logits[si].float(), want.cuda().float()
        res["logits"][str(si)] = dict(rel_l2=float((got - want).norm() / want.norm()),
                                      max_abs=float((got - want).abs().max()),
                                      max_want=float(want.abs().max()))
    del serve_params, harness
    torch.cuda.empty_cache()
    stepper, state, batch = _tp_train_step(torch, cfg, model, vqvae, params, vq_params)
    _reset(*kernels)
    state, aux = stepper.step(state, vq_params, batch, torch.Generator().manual_seed(6))
    res.update(step_counts=[k.launches for k in kernels[2:]], loss=float(aux["loss"]),
               grad_norm=float(aux["grad_norm"]), lr=float(aux["lr"]))
    grads = gather_params(mesh, tree_map(lambda t: t.grad, state.params), cfg)
    whole = gather_params(mesh, state.params, cfg)
    if rank == 0:
        torch.save({"params": tree_map(lambda t: t.cpu(), whole),
                    "grads": tree_map(lambda t: t.cpu(), grads)},
                   os.path.join(directory, "train_rank0.pt"))
    del grads, whole
    times = []
    for i in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, aux = stepper.step(state, vq_params, batch, torch.Generator().manual_seed(7 + i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        res.setdefault("timed_losses", []).append(float(aux["loss"]))
    res["step_s"] = times
    torch.save({"ids": [t.cpu() for t in ids]}, os.path.join(directory, f"ids_rank{rank}.pt"))
    del state, stepper
    distributed.shutdown()
    torch.cuda.empty_cache()
    # the command line: train --model_axis 2, one d16 step on synthetic data
    from controlvar_tpu_torch.cli import main as cli

    os.environ.update(COORDINATOR_ADDRESS=f"localhost:{port_cli}", NUM_PROCESSES="2",
                      PROCESS_ID=str(rank), DIST_BACKEND="gloo")
    _reset(*kernels)
    t = time.perf_counter()
    cli.main(["train", "--depth", "16", "--multi_cond", "--batch_size", "8", "--steps", "1",
              "--log_every", "1", "--num_workers", "1", "--model_axis", "2", "--epochs", "1"])
    torch.cuda.synchronize()
    res.update(cli_s=time.perf_counter() - t, cli_counts=[k.launches for k in kernels[2:]])
    distributed.shutdown()
    res["finite"] = all(math.isfinite(x) for x in [res["loss"], res["grad_norm"]]
                        + res["timed_losses"])
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def tp_phase(torch, cfg, smi: str):
    """Tensor parallelism over model=2 at full d16 width: the one-device
    references in this process, then two ranks on this card in a gloo group
    (NCCL refuses two ranks on one device), each running `tp_rank_main`.
    Returns a summary dict."""
    from controlvar_tpu_torch.config import SampleConfig
    from controlvar_tpu_torch.eval.harness import SamplingHarness
    from controlvar_tpu_torch.train.param_groups import named_leaves

    tmp = _scratch_dir()
    d = tmp.name
    # the one-device north-star call, recorded
    model, vqvae, params, vq_params = _tp_models(torch, cfg, None)
    harness = SamplingHarness(model, vqvae, SampleConfig())
    serve_params = harness.prepare_params(params)
    labels, cond_type, imgs = _tp_serving_inputs(torch, cfg)
    with _tp_recorded(torch) as (ids, logits):
        harness.control_conditioned(serve_params, vq_params, labels, cond_type,
                                    torch.Generator().manual_seed(11), imgs)
    torch.save({"ids": [t.cpu() for t in ids], "logits": {k: v.cpu() for k, v in logits.items()}},
               os.path.join(d, "serve_ref.pt"))
    del serve_params, harness, logits
    # the one-device train step, from the same params and draws
    stepper, state, batch = _tp_train_step(torch, cfg, model, vqvae, params, vq_params)
    state, aux = stepper.step(state, vq_params, batch, torch.Generator().manual_seed(6))
    one = dict(loss=float(aux["loss"]), grad_norm=float(aux["grad_norm"]), lr=float(aux["lr"]))
    one_params = {k: v.detach() for k, v in named_leaves(state.params)}
    one_grads = {k: v.grad for k, v in named_leaves(state.params)}
    torch.cuda.empty_cache()
    ports = [str(_free_port()), str(_free_port())]
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
                               *ports, d], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=TP_CALL_TIMEOUT_S)
            outs.append(out)
            if p.returncode != 0:
                print(out[-6000:])
                fail(f"tensor-parallel rank {r} exited with {p.returncode}")
    except subprocess.TimeoutExpired:
        fail(f"a tensor-parallel rank ran past {TP_CALL_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.time() - t0
    res = []
    for r in range(2):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            res.append(json.load(f))
    for r, x in enumerate(res):
        print(f"tensor-parallel rank {r}: mesh (data, model, data index, model index) = "
              f"{tuple(x['mesh'])}, {x['heads']} heads; serving warm-up {x['serve_warmup_s']:.3f}"
              f" s, timed call {x['serve_s']:.4f} s (K1, K2) = {tuple(x['serve_counts'])}; train "
              f"step loss {x['loss']:.6f} grad_norm {x['grad_norm']:.6f} (K3, K4) = "
              f"{tuple(x['step_counts'])}, timed steps "
              f"{', '.join(f'{s:.4f}' for s in x['step_s'])} s; CLI train --model_axis 2: "
              f"{x['cli_s']:.3f} s, (K3, K4) = {tuple(x['cli_counts'])}")
        if x["mesh"] != [1, 2, 0, r] or x["heads"] != cfg.num_heads // 2:
            fail(f"tensor-parallel rank {r}: layout {x['mesh']}, {x['heads']} heads")
        if x["serve_counts"] != [cfg.depth * cfg.num_scales, cfg.num_scales]:
            fail(f"tensor-parallel rank {r}: launches (K1, K2) = {x['serve_counts']}")
        if x["step_counts"] != [2 * cfg.depth, cfg.depth] or x["cli_counts"] != x["step_counts"]:
            fail(f"tensor-parallel rank {r}: launches (K3, K4) = {x['step_counts']}, CLI "
                 f"{x['cli_counts']}")
        if not (x["canvases_ok"] and x["finite"]):
            fail(f"tensor-parallel rank {r}: a canvas or a loss is bad")
        for si, e in x["logits"].items():
            print(f"tensor-parallel rank {r}: combined logits at scale {si} vs one device: "
                  f"rel L2 {e['rel_l2']:.3e} (limit {TP_LOGIT_REL_L2:g}), max abs "
                  f"{e['max_abs']:.3e} of max {e['max_want']:.3e}")
            if not e["rel_l2"] <= TP_LOGIT_REL_L2:
                fail(f"tensor-parallel rank {r}: scale {si} logits rel L2 {e['rel_l2']:.3e}")
    ids = [torch.load(os.path.join(d, f"ids_rank{r}.pt"), weights_only=True)["ids"]
           for r in range(2)]
    if len(ids[0]) != cfg.num_scales or not all(torch.equal(a, b) for a, b in zip(*ids)):
        fail("tensor-parallel ranks drew different ids")
    print(f"tensor-parallel ranks: every scale's ids equal on both ranks (their generators "
          f"were seeded apart: model rank 0's draw, broadcast)")
    # the train step against the one-device step
    tp = torch.load(os.path.join(d, "train_rank0.pt"), weights_only=True)
    tp_params, tp_grads = dict(named_leaves(tp["params"])), dict(named_leaves(tp["grads"]))
    x = res[0]
    _tp_step_limits(torch, "tensor-parallel train step vs one device",
                    (one["loss"], one["grad_norm"], one["lr"], one_params, one_grads),
                    (x["loss"], x["grad_norm"], None, {k: v.cuda() for k, v in tp_params.items()},
                     {k: v.cuda() for k, v in tp_grads.items()}))
    img_s = 16 / x["serve_s"]
    s_step = sum(x["step_s"]) / len(x["step_s"])
    print(f"tensor-parallel d16 (model=2): {img_s:.3f} img/s, {s_step:.4f} s/step, phase "
          f"{wall:.1f} s with the ranks' start-up, on {smi}: two ranks sharing one card over "
          f"gloo: a correctness run, not TP speed")
    tmp.cleanup()
    return dict(img_s=img_s, s_step=s_step, counts=res[0]["serve_counts"] + res[0]["step_counts"])


# ---- tensor parallelism: the Trainer's other model-axis modes -----------------

# Phase 25 holds, on two ranks of this card in a gloo group (model=2), each
# mode that `Trainer(model_axis)` trains in the JAX package beyond phase
# 24's: the options (one d16 model with separator, type_pos, shared_aln and
# bidirectional; StepwiseCondSampler refuses separator and type_pos, so the
# conditional call runs a shared_aln and bidirectional d16), LoRA over a cut
# base, and from-tokens steps with grad_accum. Rank 0 runs each one-device
# reference in its own process (no collective: rank 1 waits at the next
# one) and holds the tensor-parallel result to it at phase 24's limits.
# LoRA's factors stay whole on every rank: each factor's gradient cosine
# >= TRAIN_GRAD_COS, and both ranks' factors bit-equal after the step.
# Sampling is held by each CFG branch's own logits at scales 1 and 9
# (TP_LOGIT_REL_L2 on every branch): the combined logits (1 + t) a - t b
# cancel where the branches agree, as the joint sampler's two do at t = 4
# on the last scale, so their relative error is that of the branches times
# (|1 + t| |a| + |t| |b|) / |(1 + t) a - t b|; it is printed beside them.


def _token_batch(torch, cfg, B, seed):
    """B rows of seeded per-scale ids, classes, cond types and a
    separator-free ignore mask (about 70% ones), on the card."""
    g = torch.Generator().manual_seed(seed)
    ids = lambda: [torch.randint(0, cfg.vocab_size, (B, pn * pn), generator=g).cuda()
                   for pn in cfg.patch_nums]
    L = 2 * sum(pn * pn for pn in cfg.patch_nums)
    return dict(ctrl_ids=ids(), img_ids=ids(),
                cls=torch.randint(0, cfg.num_classes, (B,), generator=g).cuda(),
                type=torch.randint(0, 4, (B,), generator=g).cuda(),
                ignore_mask=(torch.rand(B, L, generator=g) < 0.7).float().cuda())


def tp_modes_rank_main(rank: int, port: str, port_cli: str, directory: str) -> None:
    """One rank of phase 25 (`python3 chip_smoke.py --tp-modes-rank RANK PORT
    PORT_CLI DIR`): a gloo group of two on this card, make_mesh(model=2),
    then on the option model a StepwiseJointSampler call at B=8 with the
    ranks' generators seeded apart (the ids equal) and one on the
    one-device call's ids (its combined logits at scales 1 and 9 against
    that call's), a train step in each stream order, a from-tokens step with
    grad_accum=2; StepwiseCondSampler on the shared_aln model on the
    one-device call's ids; a rank-16 LoRA step over the cut d16 base with
    random B; then `cli.main train --model_axis 2 --lora 16 --separator
    --type_pos --bidirectional --steps 1` on a second group. Every count is
    set to 0 just before each path and read just after, on the one-device
    reference and on the tensor-parallel run. Writes DIR/rank<RANK>.json."""
    import faulthandler
    import math

    import torch
    import torch.distributed as dist

    import controlvar_tpu_torch.eval.stepwise as stepwise
    from controlvar_tpu_torch.ckpt.lora import LoRAConfig, init_lora_params
    from controlvar_tpu_torch.config import (OptimConfig, VQVAEConfig,
                                             control_var_config_from_depth)
    from controlvar_tpu_torch.device import tree_map
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.ops.attention import (decode_attention, flash_attention,
                                                    flash_attention_bwd)
    from controlvar_tpu_torch.ops.sample_kernel import sample_top_k_top_p_bisect
    from controlvar_tpu_torch.parallel import distributed
    from controlvar_tpu_torch.parallel.mesh import Mesh, make_mesh
    from controlvar_tpu_torch.parallel.tensor import gather_params, shard_params
    from controlvar_tpu_torch.train.param_groups import named_leaves
    from controlvar_tpu_torch.train.train_step import (ControlVARTrainStep,
                                                       LoRAControlVARTrainStep, init_train_state)

    # a rank that hangs in a collective prints where before its parent's limit
    faulthandler.dump_traceback_later(TP_CALL_TIMEOUT_S - 30, exit=True)
    kernels = (decode_attention, sample_top_k_top_p_bisect, flash_attention, flash_attention_bwd)
    counts = lambda: [k.launches for k in kernels]
    opt_cfg = control_var_config_from_depth(16, multi_cond=True, separator=True, type_pos=True,
                                            shared_aln=True, bidirectional=True)
    sh_cfg = control_var_config_from_depth(16, multi_cond=True, shared_aln=True,
                                           bidirectional=True)
    base_cfg = control_var_config_from_depth(16, multi_cond=True)
    distributed.initialize(f"localhost:{port}", 2, rank, backend="gloo")
    mesh = make_mesh(model=2)
    # the one-device references' layout: rank 0 alone, so that their steps
    # average over a group of one and not over the world
    solo = Mesh(data=1, model=1, data_group=dist.new_group([0]))
    res = {"rank": rank, "mesh": [mesh.data, mesh.model, mesh.data_index, mesh.model_index],
           "counts": {}, "one_counts": {}, "times": {}}
    vqvae = VQVAE(VQVAEConfig())
    vq_params = vqvae.init_params(1)
    B = 8
    g = torch.Generator().manual_seed(31)
    labels = torch.randint(0, opt_cfg.num_classes, (B,), generator=g)
    cond_type = torch.randint(0, 4, (B,), generator=g)

    def run(label, fn, one_device=False):
        """fn() with every count set to 0 just before and read just after."""
        _reset(*kernels)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        (res["one_counts"] if one_device else res["counts"])[label] = counts()
        dt = time.perf_counter() - t
        if not one_device:
            res["times"][label] = dt
        print(f"phase 25 rank {rank}: {label}{' (one device)' if one_device else ''}: "
              f"{dt:.3f} s", flush=True)
        return out

    def models(cfg, seed):
        """(one-device model, tensor-parallel model, whole params with the
        gates raised, this rank's shard)."""
        one, tp = ControlVARModel(cfg, mesh=solo), ControlVARModel(cfg, mesh=mesh)
        whole = raise_gates(one.init_params(seed))
        return one, tp, whole, shard_params(mesh, whole, mesh.model_index, cfg)

    def sampling(label, sampler_cls, cfg, seed, forced=None):
        """The one-device call on rank 0 (its ids sent to rank 1), then the
        tensor-parallel call on those ids: the combined logits of scales 1
        and 9 against the one-device call's (rank 0). With forced (the
        conditional sampler), both calls take those control ids."""
        one, tp, whole, shard = models(cfg, seed)
        kw = {} if forced is None else {"forced_ids": forced}
        s_one, s_tp = sampler_cls(one, vqvae), sampler_cls(tp, vqvae)
        ref, ref_logits, ref_branches, branches = [None], None, {}, {}
        if rank == 0:
            p1 = s_one.prepare_params(whole)
            with _tp_recorded(torch, branches=ref_branches) as (ids, ref_logits):
                run(label, lambda: s_one(p1, vq_params, labels, cond_type,
                                         torch.Generator().manual_seed(11), **kw), True)
            ref = [[t.cpu() for t in ids]]
            del p1
        dist.broadcast_object_list(ref, src=0)
        p = s_tp.prepare_params(shard)
        if sampler_cls is stepwise.StepwiseJointSampler:
            # the ranks' generators seeded apart: their ids must still agree
            with _tp_recorded(torch) as (ids, _):
                run(label, lambda: s_tp(p, vq_params, labels, cond_type,
                                        torch.Generator().manual_seed(12 + rank)))
            torch.save([t.cpu() for t in ids], os.path.join(directory, f"ids_rank{rank}.pt"))
        with _tp_recorded(torch, ref[0], branches) as (_, logits):
            run(label + " on the one-device ids",
                lambda: s_tp(p, vq_params, labels, cond_type, torch.Generator().manual_seed(11),
                             **kw))
        if rank == 0:
            res[label] = {}
            rel = lambda a, b: float((a - b).norm() / b.norm())
            for si, want in ref_logits.items():
                per = [rel(a, b) for a, b in zip(branches[si].split(B), ref_branches[si].split(B))]
                res[label][str(si)] = e = dict(branch_rel_l2=per,
                                               combined_rel_l2=rel(logits[si], want))
                print(f"phase 25 {label}: logits at scale {si} vs one device: rel L2 of each CFG "
                      f"branch {', '.join(f'{x:.3e}' for x in per)} (limit "
                      f"{TP_LOGIT_REL_L2:g}); of the combined logits "
                      f"{e['combined_rel_l2']:.3e}", flush=True)
                if not max(per) <= TP_LOGIT_REL_L2:
                    fail(f"phase 25 {label}: scale {si} branch logits rel L2 {max(per):.3e}")
        del p, shard, whole
        torch.cuda.empty_cache()

    sampling("joint (separator, type_pos, shared_aln, bidirectional)",
             stepwise.StepwiseJointSampler, opt_cfg, 2)
    forced = [torch.randint(0, sh_cfg.vocab_size, (B, pn * pn), generator=g).cuda()
              for pn in sh_cfg.patch_nums]
    sampling("cond (shared_aln, bidirectional)", stepwise.StepwiseCondSampler, sh_cfg, 3,
             forced)

    optim = OptimConfig(total_batch_size=B)

    def step_pair(label, cfg, seed, batch, step_kw, params_of=None, lora=None):
        """The one-device step (rank 0) and the tensor-parallel step from the
        same params, batch and generator; rank 0 holds them to the limits."""
        one, tp, whole, shard = models(cfg, seed)
        outs = {}
        for name, model, params in (("one", one, whole), ("tp", tp, shard)):
            if name == "one" and rank != 0:
                continue
            stepper = ControlVARTrainStep(model, vqvae, optim, max_steps=1000, warmup_steps=10)
            if lora is None:
                state = init_train_state(tree_map(lambda t: t.clone(), params), optim)
                fn = lambda: stepper.step(state, vq_params, batch,
                                          torch.Generator().manual_seed(6), **step_kw)
            else:
                lstep = LoRAControlVARTrainStep(stepper, LoRAConfig(rank=16))
                state = lstep.init_lora_state(torch.Generator().manual_seed(7), whole, optim)
                with torch.no_grad():
                    for key, ab in state.params.items():
                        ab["A"].copy_(lora[key]["A"])
                        ab["B"].copy_(lora[key]["B"])
                fn = lambda: lstep.step(state, params, vq_params, batch,
                                        torch.Generator().manual_seed(6), **step_kw)
            _, aux = run(label, fn, name == "one")
            grads = tree_map(lambda t: t.grad, state.params)
            if name == "tp" and lora is None:
                grads = gather_params(mesh, grads, cfg)
                after = gather_params(mesh, state.params, cfg)
            else:
                after = tree_map(lambda t: t.detach(), state.params)
            outs[name] = (float(aux["loss"]), float(aux["grad_norm"]), float(aux["lr"]),
                          dict(named_leaves(after)), dict(named_leaves(grads)))
            if not all(map(math.isfinite, outs[name][:2])):
                fail(f"phase 25 {label}: a non-finite loss or grad_norm")
            del state
        if lora is not None:  # both ranks' factors, bit for bit
            mine = torch.cat([t.reshape(-1) for _, t in sorted(outs["tp"][3].items())])
            other = mine.clone()
            dist.broadcast(other, src=1)
            if rank == 0 and not torch.equal(mine, other):
                fail(f"phase 25 {label}: the ranks' factors differ after the step")
        if rank == 0:
            names = list(outs["one"][4]) if lora is not None else None
            res[label] = _tp_step_limits(torch, f"phase 25 {label}", outs["one"], outs["tp"],
                                         names)
        del outs, whole, shard
        torch.cuda.empty_cache()

    pixels = _pixel_batch(torch, B, opt_cfg.num_classes, 5)
    for mf in (True, False):
        step_pair(f"train step mask_first={mf}", opt_cfg, 0, pixels, dict(mask_first=mf))
    step_pair("from-tokens step, grad_accum=2", opt_cfg, 0, _token_batch(torch, opt_cfg, B, 8),
              dict(from_tokens=True, accum=2))
    # LoRA r16 over the plain d16 (every target, ada_lin's columns cut), B random
    lora = init_lora_params(torch.Generator().manual_seed(7),
                            ControlVARModel(base_cfg).init_params(0), LoRAConfig(rank=16))
    gb = torch.Generator().manual_seed(9)
    for ab in lora.values():
        ab["B"] = (0.01 * torch.randn(ab["B"].shape, generator=gb)).cuda()
    step_pair("LoRA r16 step", base_cfg, 0, pixels, {}, lora=lora)
    del lora, pixels
    distributed.shutdown()
    torch.cuda.empty_cache()
    from controlvar_tpu_torch.cli import main as cli

    os.environ.update(COORDINATOR_ADDRESS=f"localhost:{port_cli}", NUM_PROCESSES="2",
                      PROCESS_ID=str(rank), DIST_BACKEND="gloo")
    run("CLI train --model_axis 2 --lora 16 --separator --type_pos --bidirectional",
        lambda: cli.main(["train", "--depth", "16", "--multi_cond", "--batch_size", "8",
                          "--steps", "1", "--log_every", "1", "--num_workers", "1",
                          "--model_axis", "2", "--epochs", "1", "--lora", "16", "--separator",
                          "--type_pos", "--bidirectional"]))
    distributed.shutdown()
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def tp_modes_phase(torch, smi: str):
    """Phase 25: two ranks of `tp_modes_rank_main` on this card in a gloo
    group. Returns the rank-0 result dict (the limits were held there)."""
    tmp = _scratch_dir()
    d = tmp.name
    ports = [str(_free_port()), str(_free_port())]
    t0 = time.time()
    logs = [os.path.join(d, f"rank{r}.log") for r in range(2)]
    procs = []
    for r in range(2):
        with open(logs[r], "w") as log:  # a file, not a pipe: no rank blocks on its output
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                           "--tp-modes-rank", str(r), *ports, d], stdout=log,
                                          stderr=subprocess.STDOUT, text=True))

    def tail(r):
        with open(logs[r]) as f:
            return f.read()[-6000:]

    try:
        for r, p in enumerate(procs):
            p.wait(timeout=max(1.0, TP_CALL_TIMEOUT_S - (time.time() - t0)))
            if r == 0:
                with open(logs[0]) as f:
                    print("\n".join(line for line in f.read().splitlines()
                                    if line.startswith("phase 25") or "FAIL" in line))
            if p.returncode != 0:
                print(tail(1 - r), "\n----\n", tail(r))
                fail(f"phase 25: rank {r} exited with {p.returncode}")
    except subprocess.TimeoutExpired:
        print(tail(0), "\n----\n", tail(1))
        fail(f"phase 25: a rank ran past {TP_CALL_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.time() - t0
    res = []
    for r in range(2):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            res.append(json.load(f))
    ids = [torch.load(os.path.join(d, f"ids_rank{r}.pt"), weights_only=True) for r in range(2)]
    if len(ids[0]) != 10 or not all(torch.equal(a, b) for a, b in zip(*ids)):
        fail("phase 25: the ranks' joint draws differ")
    print("phase 25: the joint call's ids equal on both ranks (generators seeded apart)")
    step = _launches_per_step(16, "full")
    want = {"joint (separator, type_pos, shared_aln, bidirectional)": [160, 10, 0, 0],
            "cond (shared_aln, bidirectional)": [160, 10, 0, 0],
            "train step mask_first=True": [0, 0, *step],
            "train step mask_first=False": [0, 0, *step],
            "from-tokens step, grad_accum=2": [0, 0, 2 * step[0], 2 * step[1]],
            "LoRA r16 step": [0, 0, *step]}
    for r, x in enumerate(res):
        if x["mesh"] != [1, 2, 0, r]:
            fail(f"phase 25: rank {r} layout {x['mesh']}")
        for label, c in x["counts"].items():
            base = label.replace(" on the one-device ids", "")
            expect = want.get(base, [0, 0, *step])
            one = res[0]["one_counts"].get(base)
            print(f"phase 25 rank {r}: {label}: (K1, K2, K3, K4) = {tuple(c)} (one device "
                  f"{tuple(one) if one else 'not run'}), {x['times'][label]:.3f} s")
            if c != expect or (one is not None and one != expect):
                fail(f"phase 25 rank {r}: {label}: launches {c}, one device {one}, expected "
                     f"{expect}")
    print(f"phase 25: {wall:.1f} s with the ranks' start-up, on {smi}: two ranks sharing one "
          f"card over gloo, a correctness run, not TP speed")
    tmp.cleanup()
    return dict(res[0], wall=wall)


def read_png(path):
    """The (H, W, 3) uint8 pixels of an 8-bit RGB PNG as `write_png` writes
    it (one IDAT stream, every scanline with filter type 0)."""
    import struct
    import zlib

    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path}: not a PNG")
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        n, tag = struct.unpack(">I", data[pos: pos + 4])[0], data[pos + 4: pos + 8]
        body = data[pos + 8: pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
            if body[8:10] != b"\x08\x02":
                fail(f"{path}: not 8-bit RGB")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if (rows[:, 0] != 0).any():
        fail(f"{path}: a scanline filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


KERNEL_NAMES = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8")


def _kernel_wrappers():
    from controlvar_tpu_torch.ops import attention as a
    from controlvar_tpu_torch.ops.sample_kernel import sample_top_k_top_p_bisect

    return (a.decode_attention, sample_top_k_top_p_bisect, a.flash_attention,
            a.flash_attention_bwd, a.decode_attention_prefix, a.decode_attention_inplace,
            a.decode_attention_flat, a.decode_attention_fused)


def cli_phase(torch, cfg, seed: int = 7):
    """The port's command line in this process (the kernels are built):
    d16 and ch-160 .pth files, then eval-cond (both forces), sample (joint,
    kv_window 2, sort), fid (one shard and two), train -> export, train-var,
    train-vqvae --dual, pretokenize -> train --token_shards. Returns
    ({run: launches of K1-K8}, the eval-cond loop's img/s, the bare harness
    calls' img/s, the PNG writes' share of the loop)."""
    import dataclasses
    import shutil

    import numpy as np

    from controlvar_tpu_torch.ckpt.orbax_io import CheckpointIO
    from controlvar_tpu_torch.ckpt.torch_export import (export_control_var_state_dict,
                                                        export_vqvae_state_dict,
                                                        save_torch_checkpoint)
    from controlvar_tpu_torch.ckpt.torch_import import (convert_control_var_state_dict,
                                                        convert_vqvae_state_dict,
                                                        load_torch_state_dict)
    from controlvar_tpu_torch.cli import main as cli
    from controlvar_tpu_torch.config import SampleConfig, VQVAEConfig
    from controlvar_tpu_torch.data import imagenetc
    from controlvar_tpu_torch.data.build import Loader, create_dataset, to_device
    from controlvar_tpu_torch.device import generator_for
    from controlvar_tpu_torch.eval import serving
    from controlvar_tpu_torch.eval.harness import SamplingHarness, _to_uint8
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.train.param_groups import named_leaves
    from controlvar_tpu_torch.utils import tracker

    scratch = os.path.join(ROOT, ".chip_scratch")  # listed in .gitignore
    shutil.rmtree(scratch, ignore_errors=True)
    os.makedirs(scratch)
    at = lambda *p: os.path.join(scratch, *p)
    vq_cfg = VQVAEConfig()
    t0 = time.time()
    params = raise_gates(ControlVARModel(cfg).init_params(0))
    save_torch_checkpoint(at("d16.pth"), export_control_var_state_dict(params, cfg))
    save_torch_checkpoint(at("vae.pth"), export_vqvae_state_dict(VQVAE(vq_cfg).init_params(1),
                                                                 vq_cfg))
    del params
    print(f"cli: d16 (gates raised) and ch-160 VQVAE .pth written in {time.time() - t0:.1f} s")
    ckpts = ["--ckpt", at("d16.pth"), "--vae_ckpt", at("vae.pth"), "--seed", str(seed)]
    wrappers = _kernel_wrappers()
    png_s, loop_s = [0.0], [0.0]
    orig_png, orig_map = tracker.write_png, serving.pipelined_map

    def timed_png(path, rgb):
        t = time.perf_counter()
        orig_png(path, rgb)
        png_s[0] += time.perf_counter() - t

    def timed_map(fn, items, depth=2):
        t = time.perf_counter()
        yield from orig_map(fn, items, depth)
        loop_s[0] += time.perf_counter() - t

    counts = {}

    def run(label, argv, expect=None):
        """cli.main(argv) with every count set to 0 just before it and read
        just after; expect: {kernel name: launches}."""
        _reset(*wrappers)
        png_s[0] = loop_s[0] = 0.0
        torch.cuda.synchronize()
        t = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        got = dict(zip(KERNEL_NAMES, (w.launches for w in wrappers)))
        counts[label] = {k: v for k, v in got.items() if v}
        print(f"cli {label}: {dt:.2f} s, launches {counts[label]}", flush=True)
        for k, n in (expect or {}).items():
            if got[k] != n:
                fail(f"cli {label}: {k} launched {got[k]} times, expected {n}")
        return dt

    tracker.write_png, serving.pipelined_map = timed_png, timed_map
    try:
        # eval-cond --force control: two d16 B=16 batches, K1 16 x 10 a batch
        out = at("val")
        run("eval-cond control", ["eval-cond", *ckpts, "--data", "synthetic", "--batch_size",
                                  "16", "--max_batches", "2", "--out", out],
            {"K1": 320, "K2": 20, "K5": 0, "K6": 0})
        cli_loop, cli_png = loop_s[0], png_s[0]
        pngs = sorted(glob.glob(os.path.join(out, "cfg_6_6_6_depth", "0", "*.png")))
        if len(pngs) != 32:
            fail(f"cli eval-cond: {len(pngs)} PNGs, expected 32")
        # the same batches through the bare harness, as the CLI built it
        cv = ControlVARModel(cfg)
        vqvae = VQVAE(vq_cfg)
        h = SamplingHarness(cv, vqvae, SampleConfig(cfg=(6.0, 6.0, 6.0), seed=seed),
                            decode_generated_only=True)
        p = h.prepare_params(convert_control_var_state_dict(load_torch_state_dict(
            at("d16.pth")), cfg))
        vq = convert_vqvae_state_dict(load_torch_state_dict(at("vae.pth")), vq_cfg)
        ds = create_dataset("synthetic", num_classes=cfg.num_classes, patch_nums=cfg.patch_nums,
                            image_size=256)
        bare, t_load = 0.0, time.perf_counter()
        batches = []
        for bi, batch in enumerate(Loader(ds, batch_size=16, shuffle=False,
                                          drop_last=False).epoch(0)):
            if bi == 2:
                break
            batches.append(batch)
        t_load = time.perf_counter() - t_load
        for bi, batch in enumerate(batches):
            labels = to_device(batch["cls"].astype(np.int64), "cuda")
            ct = to_device(batch["type"].astype(np.int64), "cuda")
            mask = to_device(batch["mask"], "cuda")
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, img = h.control_conditioned(p, vq, labels, ct, generator_for(seed + bi), mask)
            torch.cuda.synchronize()
            bare += time.perf_counter() - t
            want = _to_uint8(img)
            for b in range(16):
                got = read_png(os.path.join(out, "cfg_6_6_6_depth", "0", f"{bi * 16 + b}.png"))
                if not np.array_equal(got, want[b]):
                    fail(f"cli eval-cond: {bi * 16 + b}.png differs from the harness call "
                         f"(max |d| {np.abs(got.astype(int) - want[b]).max()})")
        del p, vq, h
        cli_img_s, bare_img_s = 32 / cli_loop, 32 / bare
        print(f"cli eval-cond: 32 PNGs bit-equal to _to_uint8 of direct harness calls; CLI "
              f"loop {cli_loop:.3f} s = {cli_img_s:.3f} img/s, bare harness calls "
              f"{bare:.3f} s = {bare_img_s:.3f} img/s; the CLI adds "
              f"{(cli_loop - bare) / cli_loop:.3f} of its loop; PNG encode {cli_png:.3f} s = "
              f"{cli_png / cli_loop:.3f} of the loop ({cli_png / 32 * 1e3:.2f} ms an image); "
              f"loading two batches alone {t_load:.3f} s")
        run("eval-cond image", ["eval-cond", *ckpts, "--data", "synthetic", "--batch_size",
                                "16", "--max_batches", "1", "--force", "image",
                                "--out", at("val_img")], {"K1": 160, "K2": 10})
        if len(glob.glob(at("val_img", "cfg_6_6_6_depth", "0", "*.png"))) != 16:
            fail("cli eval-cond --force image: expected 16 PNGs")
        for label, extra, expect in (
                ("sample joint", [], {"K1": 160, "K2": 10}),
                ("sample kv_window=2", ["--kv_window", "2"], {"K1": 16, "K5": 144, "K2": 10}),
                ("sample sort", ["--sampler", "sort"], {"K1": 160, "K2": 0})):
            d = at("sample_" + label.split()[1])
            run(label, ["sample", *ckpts, "--batch_size", "16", "--out", d, *extra], expect)
            files = sorted(glob.glob(os.path.join(d, "*.png")))
            if len(files) != 16 or read_png(files[0]).shape != (512, 256, 3):
                fail(f"cli {label}: expected 16 PNGs of 512 x 256 (control above image)")
        fid = ["fid", *ckpts, "--gen_classes", "2", "--images_per_class", "16",
               "--batch_size", "16"]
        run("fid one shard", [*fid, "--out", at("fid1")], {"K1": 320, "K2": 20})
        for shard in range(2):
            run(f"fid shard {shard} of 2", [*fid, "--out", at("fid2"), "--shard_id", str(shard),
                                            "--num_shards", "2"], {"K1": 160, "K2": 10})
        one = sorted(os.path.relpath(f, at("fid1")) for f in glob.glob(at("fid1", "*", "*.png")))
        two = sorted(os.path.relpath(f, at("fid2")) for f in glob.glob(at("fid2", "*", "*.png")))
        if one != two or len(one) != 32:
            fail(f"cli fid: {len(one)} / {len(two)} files, or other names")
        for name in one:
            with open(at("fid1", name), "rb") as a, open(at("fid2", name), "rb") as b:
                if a.read() != b.read():
                    fail(f"cli fid: {name} differs between one shard and two")
        print(f"cli fid: one shard and two shards wrote the same {len(one)} files, bit for bit")
    finally:
        tracker.write_png, serving.pipelined_map = orig_png, orig_map

    train = ["--depth", "16", "--vae_ckpt", at("vae.pth"), "--data", "synthetic",
             "--batch_size", "8", "--seed", str(seed)]
    steps = lambda n: {"K3": 32 * n, "K4": 16 * n}
    run("train", ["train", *train, "--steps", "3", "--log_every", "1", "--num_workers", "4",
                  "--ckpt_dir", at("ck")], steps(3))
    run("export", ["export", "--depth", "16", "--ckpt_dir", at("ck"), "--out", at("e.pth")])
    state, _ = CheckpointIO(at("ck")).restore_raw()
    back = dict(named_leaves(convert_control_var_state_dict(load_torch_state_dict(
        at("e.pth")), cfg, device="cpu")))
    want = dict(named_leaves(state["params"]))
    if sorted(back) != sorted(want) or any(
            not np.array_equal(back[k].numpy(), want[k]) for k in want):
        fail("cli export: the re-imported .pth differs from the checkpoint's params")
    print(f"cli export: the re-imported .pth equals the step-{state['step']} checkpoint's "
          f"{len(want)} params bit for bit")
    del state, back, want
    run("train-var", ["train-var", *train, "--steps", "2"], steps(2))
    run("train-vqvae --dual", ["train-vqvae", "--vae_ch", "160", "--data", "synthetic",
                               "--batch_size", "8", "--steps", "2", "--dual",
                               "--seed", str(seed)])

    @dataclasses.dataclass
    class Short(imagenetc.SyntheticControlDataset):
        length: int = 32

    orig_ds = imagenetc.SyntheticControlDataset
    imagenetc.SyntheticControlDataset = Short
    print("cli pretokenize: SyntheticControlDataset.length set to 32 for this call "
          "(10,000 by default; the CLI has no flag for it)")
    try:
        run("pretokenize", ["pretokenize", "--depth", "16", "--vae_ckpt", at("vae.pth"),
                            "--batch_size", "8", "--out", at("tok")])
    finally:
        imagenetc.SyntheticControlDataset = orig_ds
    if len(glob.glob(at("tok", "*.npz"))) != 4:
        fail("cli pretokenize: expected 4 token shards")
    run("train --token_shards", ["train", *train, "--token_shards", at("tok", "*.npz"),
                                 "--steps", "2", "--log_every", "1"], steps(2))
    shutil.rmtree(scratch, ignore_errors=True)
    return counts, cli_img_s, bare_img_s, cli_png / cli_loop


def _host_rss_gib() -> float:
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) for line in f if line.startswith("VmRSS:")) / 2 ** 20


def _with_host_peak(fn):
    """fn() with its host seconds and the peak of this process's resident
    memory above its start (GiB), read every 10 ms by a thread."""
    import threading

    base = _host_rss_gib()
    peak, done = [base], threading.Event()

    def poll():
        while not done.wait(0.01):
            peak[0] = max(peak[0], _host_rss_gib())

    thread = threading.Thread(target=poll)
    thread.start()
    t = time.perf_counter()
    try:
        out = fn()
    finally:
        done.set()
        thread.join()
    return out, time.perf_counter() - t, peak[0] - base


def d30_kernel_phase(torch, cfg):
    """K1 at every scale of the d30 conditional (64 CFG rows) and joint (16)
    paths and K3/K4 at the d30 training shape (8, 30, 1360, 64), on cos_attn
    inputs: q and k L2-normalised, q times exp(min(s, log 100)) per head
    with s from random_scale_mul (scores up to +-100), scale 1; the limits
    of the d16 checks, and the times at the final scale and the training
    shape; then the same at a model = 2 rank's shapes (phase 28: 15 of the
    30 heads), K1 at the joint path's final scale (16, 15, 512, 64) and
    K3/K4 at (8, 15, 1360, 64). Returns {kernel: {path: times}}."""
    import math

    from controlvar_tpu_torch.models.masks import attn_mask_for_config
    from controlvar_tpu_torch.ops.attention import (decode_attention, decode_attention_plain,
                                                    flash_attention)

    g = torch.Generator(device="cuda").manual_seed(30)
    dev, bf, H, hd, L = "cuda", torch.bfloat16, cfg.num_heads, cfg.head_dim, cfg.seq_len
    sm = torch.exp(torch.clamp(random_scale_mul(torch, (H,), 30), max=math.log(100.0))).to(dev)
    unit = lambda x: x / x.norm(dim=-1, keepdim=True)

    def qkv(B, l, heads=H):
        """The strided (B, heads, l, hd) q, k, v views of one fused QKV
        output after cos_attn's normalisation, as the blocks give them."""
        x = torch.randn(B, l, 3, heads, hd, generator=g, device=dev)
        x[:, :, 0] = unit(x[:, :, 0]) * sm[:heads, None]
        x[:, :, 1] = unit(x[:, :, 1])
        return x.to(bf).permute(2, 0, 3, 1, 4)

    errs, times = {"K1": [], "K3": [], "K4": []}, {"K1": {}, "K3": {}, "K4": {}}
    for rows, path in ((64, "conditional"), (16, "joint")):
        ck = unit(torch.randn(2, rows, H, L, hd, generator=g, device=dev)).to(bf)
        cv = torch.randn(2, rows, H, L, hd, generator=g, device=dev).to(bf)
        for si, (lo, cur) in enumerate(cfg.begin_ends):
            q = qkv(rows, cur - lo)[0]
            kk, vv = ck[si % 2, :, :, :cur], cv[si % 2, :, :, :cur]
            errs["K1"].append(check_close(
                f"K1 d30 {path} ({rows} rows x {H} heads, cos_attn) l={cur - lo} cur={cur}",
                decode_attention(q, ck, cv, si % 2, cur, 1.0),
                decode_attention_plain(q, kk, vv, 1.0), decode_attention_plain(q, kk, vv.abs(), 1.0)))
        lo = cfg.begin_ends[-1][0]
        times["K1"][path] = _k1_times(
            torch, f"d30 {path} final scale ({rows}, {H}, {L - lo}, {hd}) over {L} rows, cos_attn",
            qkv(rows, L - lo)[0], ck, cv, 1, L, 1.0)
        del ck, cv
        torch.cuda.empty_cache()
    mask = torch.from_numpy(attn_mask_for_config(cfg)).to(dev)
    name = f"d30 train (8, {H}, {L}, {hd}), block-causal, strided, cos_attn, scale 1"
    q, k, v = qkv(8, L)
    do = torch.randn(8, L, H, hd, generator=g, device=dev).to(bf).transpose(1, 2)
    out, lse = flash_attention(q, k, v, mask, 1.0)
    errs["K3"].append(_check_k3(torch, name, q, k, v, mask, 1.0, out, lse))
    errs["K4"] += _check_k4(torch, name, q, k, v, do, mask, 1.0)
    del out, lse
    t3, t4 = _flash_times(torch, f"d30 train shape (8, {H}, {L}, {hd}), cos_attn", q, k, v, do,
                          mask, 1.0)
    for kname, (ms, plain, lib, b) in (("K3", t3), ("K4", t4)):
        times[kname]["train"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b[0],
                                     bound_by=b[1])
    del q, k, v, do
    torch.cuda.empty_cache()
    # a model = 2 rank's shapes (phase 28): 15 of the 30 heads
    Hr, lo = H // 2, cfg.begin_ends[-1][0]
    ck = unit(torch.randn(2, 16, Hr, L, hd, generator=g, device=dev)).to(bf)
    cv = torch.randn(2, 16, Hr, L, hd, generator=g, device=dev).to(bf)
    q = qkv(16, L - lo, Hr)[0]
    errs["K1"].append(check_close(
        f"K1 d30 rank (16 rows x {Hr} heads, cos_attn) l={L - lo} cur={L}",
        decode_attention(q, ck, cv, 1, L, 1.0), decode_attention_plain(q, ck[1], cv[1], 1.0),
        decode_attention_plain(q, ck[1], cv[1].abs(), 1.0)))
    times["K1"]["tp_rank"] = _k1_times(
        torch, f"d30 rank joint final scale (16, {Hr}, {L - lo}, {hd}) over {L} rows, cos_attn",
        q, ck, cv, 1, L, 1.0)
    del ck, cv
    name = f"d30 rank train (8, {Hr}, {L}, {hd}), block-causal, strided, cos_attn, scale 1"
    q, k, v = qkv(8, L, Hr)
    do = torch.randn(8, L, Hr, hd, generator=g, device=dev).to(bf).transpose(1, 2)
    out, lse = flash_attention(q, k, v, mask, 1.0)
    errs["K3"].append(_check_k3(torch, name, q, k, v, mask, 1.0, out, lse))
    errs["K4"] += _check_k4(torch, name, q, k, v, do, mask, 1.0)
    del out, lse
    t3, t4 = _flash_times(torch, f"d30 rank train shape (8, {Hr}, {L}, {hd}), cos_attn", q, k,
                          v, do, mask, 1.0)
    for kname, (ms, plain, lib, b) in (("K3", t3), ("K4", t4)):
        times[kname]["tp_rank"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b[0],
                                       bound_by=b[1])
    for kname, e in errs.items():
        times[kname]["max_abs_err"] = max(e)
    return times


def d30_reference(torch):
    """Small inputs with cos_attn against the CPU: one bf16 decode step
    through K1 and one bf16 train step through K3/K4 against fp32, with
    scale_mul from random_scale_mul and the gates raised."""
    from controlvar_tpu_torch.config import ControlVARConfig
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.ops.attention import decode_attention

    cfg = ControlVARConfig(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 4),
                           vocab_size=64, cvae=32, num_classes=8, multi_cond=True,
                           cos_attn=True)
    blocks = raise_gates(ControlVARModel(cfg, device="cpu").init_params(1))["blocks"]
    blocks["scale_mul"] = random_scale_mul(torch, (2, 2), TINY_COS_SEED)
    xs = _decode_inputs(torch, 128)
    want = _decode_two_steps(torch, cfg, blocks, xs, "cpu", torch.float32)
    decode_attention.launches = 0
    got = _decode_two_steps(torch, cfg, blocks, xs, "cuda", torch.bfloat16)
    rel = float((got - want).norm() / want.norm())
    print(f"reference: bf16 GPU cos_attn decode step (K1) vs fp32 CPU: relative error "
          f"{rel:.3e}, {decode_attention.launches} launches")
    if rel > 2e-2:
        fail(f"reference: cos_attn decode step relative error {rel:.3e} > 2e-2")
    if decode_attention.launches != 4:
        fail(f"reference: cos_attn decode step launched K1 {decode_attention.launches} "
             f"times, not 4")
    _check_train_step(torch, "cos_attn train step",
                      functools.partial(_tiny_train, cos_attn=True), bf16_floor=True)


def d30_train_phase(torch, cfg, optim, profile: bool):
    """BASELINE config 5 on the card: ControlVARTrainStep at the d30
    recipe, the ch-160 VQVAE frozen inside, B=8 pixel batches, remat full,
    one warm-up and three timed steps (K3 60, K4 30 a step). Returns the
    params after the steps (no gradients) and the numbers."""
    import math

    from controlvar_tpu_torch.config import VQVAEConfig
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.train.param_groups import named_leaves
    from controlvar_tpu_torch.train.train_step import ControlVARTrainStep, init_train_state

    B = 8
    model, vqvae = ControlVARModel(cfg), VQVAE(VQVAEConfig())
    params, init_s, init_gib = _with_host_peak(lambda: model.init_params(0))
    n_params = sum(leaf.numel() for _, leaf in named_leaves(params))
    print(f"d30 train path: init_params(0) of {n_params / 1e9:.4f} B params: {init_s:.2f} s of "
          f"host time, {init_gib:.2f} GiB of host memory above the start at its peak")
    state = init_train_state(params, optim)
    stepper = ControlVARTrainStep(model, vqvae, optim, max_steps=1000, warmup_steps=10)
    vq_params = vqvae.init_params(1)
    batch = _pixel_batch(torch, B, cfg.num_classes, 5)
    head0 = state.params["head"]["kernel"].detach().clone()
    gen = torch.Generator().manual_seed(6)
    expect = _launches_per_step(cfg.depth, "full")
    s_step, peak, loss0 = _timed_steps(
        torch, "d30 train path", lambda: stepper.step(state, vq_params, batch, gen)[1], expect,
        3, B, _adaln_per_step(cfg.depth), "train_d30" if profile else None)
    reserved = torch.cuda.max_memory_reserved() / 2 ** 30
    print(f"d30 train path: step-0 loss {loss0:.5f}, ln V = {math.log(cfg.vocab_size):.5f}; "
          f"peak allocated {peak:.2f} GiB, peak reserved {reserved:.2f} GiB (timed steps)")
    if abs(loss0 - math.log(cfg.vocab_size)) > 0.5:
        fail(f"d30 train path: step-0 loss {loss0:.4f} is not near ln V")
    if float((state.params["head"]["kernel"].detach() - head0).abs().max()) == 0.0:
        fail("d30 train path: the params did not change")
    for _, leaf in named_leaves(state.params):
        leaf.grad = None
        leaf.requires_grad_(False)
    return state.params, dict(s_step=s_step, peak=peak, reserved=reserved, init_s=init_s,
                              init_gib=init_gib, launches=expect)


def _generation_calls(torch, label, call, B, expect, profile_tag=None):
    """One warm-up and one timed call(seed) -> canvases, each with the K1/K2
    counts set to 0 just before it and held to `expect` just after, every
    canvas (B, 256, 256, 3), finite and in [0, 1]; with profile_tag, one
    profiled call. Returns (img/s, peak GiB of the timed call)."""
    from controlvar_tpu_torch.ops.attention import decode_attention
    from controlvar_tpu_torch.ops.sample_kernel import sample_top_k_top_p_bisect

    def one(seed):
        _reset(decode_attention, sample_top_k_top_p_bisect)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = call(seed)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = (decode_attention.launches, sample_top_k_top_p_bisect.launches)
        if counts != expect:
            fail(f"{label}: launches (K1, K2) = {counts}, expected {expect}")
        for c in out:
            if tuple(c.shape) != (B, 256, 256, 3) or not torch.isfinite(c).all():
                fail(f"{label}: bad canvas {tuple(c.shape)}")
            if float(c.min()) < 0.0 or float(c.max()) > 1.0:
                fail(f"{label}: canvas outside [0, 1]")
        return dt

    dt_warm = one(10)
    torch.cuda.reset_peak_memory_stats()
    dt = one(11)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label}: warm-up call {dt_warm:.3f} s; timed call {dt:.4f} s for {B} images = "
          f"{B / dt:.3f} img/s; peak memory {peak:.2f} GiB; launches K1={expect[0]} "
          f"K2={expect[1]}")
    if profile_tag:
        busy, wall, by_cat = device_profile(torch, lambda: one(12), profile_tag)
        print(f"{profile_tag} breakdown: profiled call {wall:.2f} ms, device busy {busy:.2f} "
              f"ms, idle share {1 - busy / wall:.4f} of the profiled call, "
              f"{1 - busy / (dt * 1e3):.4f} of the timed call")
        for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
            print(f"{profile_tag} breakdown: {cat}: {ms:.2f} ms")
    return B / dt, peak


def d30_phase(torch, profile: bool):
    """The d30 paths (module docstring, phase 26): (a) the kernels at d30
    shapes, (b) the small cos_attn reference, (c) the train step, (d) the
    conditional call, (e) the joint call, (f) `cli.main train --depth 30`.
    The card is freed between them."""
    import io
    import math

    from controlvar_tpu_torch.cli import main as cli
    from controlvar_tpu_torch.config import SampleConfig, VQVAEConfig
    from controlvar_tpu_torch.eval.harness import SamplingHarness
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE

    cfg, optim = d30_recipe()
    wall = time.time()
    phase("d30 (a): K1, K3 and K4 at the d30 shapes on cos_attn inputs, scale 1")
    kernels = d30_kernel_phase(torch, cfg)
    torch.cuda.empty_cache()
    phase("d30 (b): small-input cos_attn reference")
    d30_reference(torch)
    phase("d30 (c): ControlVAR-d30 train step (BASELINE config 5), B=8")
    params, train = d30_train_phase(torch, cfg, optim, profile)
    torch.cuda.empty_cache()

    model, vqvae = ControlVARModel(cfg), VQVAE(VQVAEConfig())
    harness = SamplingHarness(model, vqvae, SampleConfig())
    params = harness.prepare_params(params)
    torch.cuda.empty_cache()
    vq_params = vqvae.init_params(1)
    S, D = cfg.num_scales, cfg.depth
    phase("d30 (d): control-conditioned generation, B=16 (4-way CFG, 64 rows)")
    g = torch.Generator().manual_seed(3)
    labels = torch.randint(0, cfg.num_classes, (16,), generator=g)
    cond_type = torch.randint(0, 4, (16,), generator=g)
    imgs = (torch.rand(16, 256, 256, 3, generator=g) * 2 - 1).cuda()
    cond = _generation_calls(
        torch, "d30 conditional path", lambda seed: harness.control_conditioned(
            params, vq_params, labels, cond_type, torch.Generator().manual_seed(seed), imgs),
        16, (D * S, S), "serve_d30" if profile else None)
    torch.cuda.empty_cache()
    phase("d30 (e): joint generation, B=8 (2-way CFG 4.0, 16 rows), stacked cache")
    labels8, types8 = torch.arange(8), torch.arange(8) % 4
    joint = _generation_calls(
        torch, "d30 joint path", lambda seed: harness.joint(
            params, vq_params, labels8, types8, torch.Generator().manual_seed(seed)),
        8, (D * S, S), "joint_d30" if profile else None)
    del params, vq_params, harness
    torch.cuda.empty_cache()

    phase("d30 (f): cli.main train --depth 30 with the d30 recipe's flags, two steps")
    wrappers = _kernel_wrappers()
    _reset(*wrappers)
    log = io.StringIO()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(log):
        cli.main(["train", *D30_TRAIN_FLAGS, "--steps", "2", "--log_every", "1",
                  "--num_workers", "4"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t
    print(log.getvalue(), end="")
    counts = dict(zip(KERNEL_NAMES, (w.launches for w in wrappers)))
    losses = [float(x) for x in re.findall(r"(?:^| )loss=(\S+)", log.getvalue(), re.M)]
    print(f"d30 cli train: {cli_s:.2f} s, launches {counts}, losses {losses}")
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want.update(K3=2 * 2 * D, K4=2 * D)
    if counts != want:
        fail(f"d30 cli train: launches {counts}, expected {want}")
    if len(losses) != 2 or not all(math.isfinite(x) for x in losses):
        fail(f"d30 cli train: logged losses {losses}, expected two finite ones")
    torch.cuda.empty_cache()
    print(f"d30 phase: {time.time() - wall:.1f} s")
    return dict(kernels=kernels, train=train, cond=cond, joint=joint, cli_s=cli_s)


# ---- phase 27: the parity tooling on the card ---------------------------------

# The JAX package's logits_parity default: teacher-forced fp32 logits within
# 5e-3 absolute of the reference's.
PARITY_ATOL = 5e-3
# A stub of the upstream checkout's `models` package for eval/parity.py: the
# constructor arguments and calls that parity makes, over the port's own
# modules on the CPU in fp32 (the card's machine has neither the checkout
# nor the released weights). Its ControlVAR takes the default attention
# path, the plain version of K3 on the CPU, where the port's side takes
# `use_flash=False` on the card: two implementations of one function.
PARITY_STUB = {
    "__init__.py": "",
    "vqvae.py": """
import torch

from controlvar_tpu_torch.ckpt.torch_import import convert_vqvae_state_dict
from controlvar_tpu_torch.config import VQVAEConfig
from controlvar_tpu_torch.models.vqvae import VQVAE as _VQVAE


class VQVAE:
    def __init__(self, vocab_size, z_channels, ch, v_patch_nums, test_mode=True):
        self.cfg = VQVAEConfig(vocab_size=vocab_size, z_channels=z_channels, ch=ch,
                               patch_nums=tuple(v_patch_nums))

    def load_state_dict(self, sd, strict=True):
        self.params = convert_vqvae_state_dict(sd, self.cfg, device="cpu")

    def eval(self):
        return self

    def img_to_idxBl(self, x, v_patch_nums=None):
        return _VQVAE(self.cfg, device="cpu").img_to_ids(self.params, x.permute(0, 2, 3, 1))
""",
    "control_var.py": """
import torch

from controlvar_tpu_torch.ckpt.torch_import import convert_control_var_state_dict
from controlvar_tpu_torch.config import control_var_config_from_depth
from controlvar_tpu_torch.models.control_var import ControlVARModel


class ControlVAR:
    def __init__(self, vae_local, depth, embed_dim, num_heads, patch_nums, mask_factor,
                 multi_cond, cond_drop_rate, flash_if_available=True,
                 fused_if_available=True):
        self.cfg = control_var_config_from_depth(depth, multi_cond=multi_cond,
                                                 cond_drop_rate=cond_drop_rate)
        assert (self.cfg.embed_dim, self.cfg.num_heads, self.cfg.mask_factor) == (
            embed_dim, num_heads, mask_factor)

    def eval(self):
        return self

    def load_state_dict(self, sd, strict=True):
        self.params = convert_control_var_state_dict(sd, self.cfg, device="cpu")

    def __call__(self, labels, x_tf, cond_type=None, mask_first=True):
        return ControlVARModel(self.cfg, device="cpu").forward_train(
            self.params, labels, x_tf, cond_type=cond_type, mask_first=mask_first,
            train=False, compute_dtype=torch.float32)
""",
}


def parity_phase(torch, cfg):
    """Phase 27: eval/parity.py and `cli.main parity` on the card against
    a stub reference tree of the port's own modules on the CPU (PARITY_STUB),
    on .pth files that the port's exporter writes from seeds: the ch-160
    VQVAE's token streams of 4 seeded 256x256 images at the 10 scales
    (bitwise), the d16 multi_cond model's (gates raised) teacher-forced
    logits at B=2 (within PARITY_ATOL, every argmax equal), then `parity
    --depth 16 --ckpt` through the CLI (--out JSON, its report the direct
    call's on the same seed: the same flags, max_abs_diff within 1e-6). Every count is set to 0 before and read
    after: the parity path launches no kernel. Returns the numbers."""
    import numpy as np

    from controlvar_tpu_torch.ckpt.torch_export import (export_control_var_state_dict,
                                                        export_vqvae_state_dict,
                                                        save_torch_checkpoint)
    from controlvar_tpu_torch.cli import main as cli
    from controlvar_tpu_torch.config import VQVAEConfig
    from controlvar_tpu_torch.eval import parity
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE

    tmp = _scratch_dir()
    at = lambda *p: os.path.join(tmp.name, *p)
    os.makedirs(at("reference", "models"))
    for name, text in PARITY_STUB.items():
        with open(at("reference", "models", name), "w") as f:
            f.write(text)
    vq_cfg = VQVAEConfig()
    t0 = time.time()
    params = raise_gates(ControlVARModel(cfg).init_params(0))
    save_torch_checkpoint(at("d16.pth"), export_control_var_state_dict(params, cfg))
    save_torch_checkpoint(at("vae.pth"), export_vqvae_state_dict(VQVAE(vq_cfg).init_params(1),
                                                                 vq_cfg))
    del params
    torch.cuda.empty_cache()
    print(f"parity: d16 (gates raised) and ch-160 VQVAE .pth written in {time.time() - t0:.1f} s")
    wrappers = _kernel_wrappers()
    saved = parity.REFERENCE_ROOT, list(sys.path)
    parity.REFERENCE_ROOT = at("reference")
    try:
        _reset(*wrappers)
        images = np.random.default_rng(27).uniform(-1, 1, (4, 256, 256, 3)).astype(np.float32)
        t = time.perf_counter()
        tokens = parity.token_stream_parity(at("vae.pth"), images)
        t_tokens = time.perf_counter() - t
        print(f"parity: token streams of 4 images at {len(vq_cfg.patch_nums)} scales, card vs "
              f"CPU, in {t_tokens:.1f} s: per-scale match "
              f"{', '.join(f'{x:.6f}' for x in tokens['per_scale_match'])}; total "
              f"{tokens['total_match_rate']:.6f}, bitwise {tokens['bitwise']}")
        flipped = [(si, round((1 - x) * 4 * pn * pn)) for si, (x, pn) in
                   enumerate(zip(tokens["per_scale_match"], vq_cfg.patch_nums)) if x < 1.0]
        if not tokens["bitwise"]:
            fail(f"parity: token streams differ, (scale, ids) = {flipped}")
        rng = np.random.default_rng(42)  # the CLI's default seed and batch size
        B = 2
        inputs = (rng.integers(0, cfg.num_classes, (B,)).astype(np.int64),
                  rng.integers(0, 4, (B,)).astype(np.int64),
                  rng.standard_normal((B, cfg.seq_len - cfg.first_l, cfg.cvae))
                  .astype(np.float32))
        t = time.perf_counter()
        logits = parity.logits_parity(at("d16.pth"), 16, *inputs)
        t_logits = time.perf_counter() - t
        print(f"parity: d16 teacher-forced logits, B={B}, card (use_flash=False) vs CPU, in "
              f"{t_logits:.1f} s: max_abs_diff {logits['max_abs_diff']:.3e} (limit "
              f"{PARITY_ATOL:g}), mean_abs_diff {logits['mean_abs_diff']:.3e}, argmax match "
              f"{logits['argmax_match_rate']:.6f}")
        if not (logits["within_tolerance"] and logits["max_abs_diff"] <= PARITY_ATOL
                and logits["argmax_match_rate"] == 1.0):
            fail(f"parity: logits {logits}")
        t = time.perf_counter()
        cli.main(["parity", "--depth", "16", "--ckpt", at("d16.pth"), "--out",
                  at("parity.json")])
        t_cli = time.perf_counter() - t
        with open(at("parity.json")) as f:
            report = json.load(f)
        print(f"parity: cli.main parity --depth 16 --ckpt in {t_cli:.1f} s: {report}")
        got = report.get("logits", {})
        if (sorted(report) != ["logits"] or sorted(got) != sorted(logits)
                or got["within_tolerance"] != logits["within_tolerance"]
                or got["argmax_match_rate"] != logits["argmax_match_rate"]
                or abs(got["max_abs_diff"] - logits["max_abs_diff"]) > 1e-6):
            fail("parity: the CLI's report differs from the direct call's on the same seed")
        counts = dict(zip(KERNEL_NAMES, (w.launches for w in wrappers)))
        print(f"parity: launches {counts} (the parity path runs no kernel)")
        if any(counts.values()):
            fail(f"parity: launches {counts}")
    finally:
        parity.REFERENCE_ROOT = saved[0]
        sys.path[:] = saved[1]
        for name in [m for m in sys.modules if m == "models" or m.startswith("models.")]:
            del sys.modules[name]
        tmp.cleanup()
    torch.cuda.empty_cache()
    return dict(tokens=tokens, logits=logits, t_tokens=t_tokens, t_logits=t_logits, t_cli=t_cli)


# ---- phase 28: ControlVAR-d30 over a model axis --------------------------------

# d30 at model = 2 on this card: two ranks over gloo, 15 of the 30 heads
# each, the MLP, ada_lin and the head cut. The parent holds each rank's
# joint call and train step against its own one-device run on the same
# weights (init_params(0), gates raised), batch and generators, at phase
# 24's limits. Of the step's params after it and its clipped gradients the
# parent holds the first and the last layer (D30_TP_LAYERS) and every leaf
# outside the blocks: all 30 layers of 2.0 B params, gathered, would be 16
# GB through files. The loss and grad_norm cover the whole model.
D30_TP_LAYERS = (0, 29)
D30_TP_TIMEOUT_S = 600


def _d30_subtree(tree):
    """tree with every leaf under "blocks" cut to D30_TP_LAYERS (its depth
    dimension kept), the others as they are."""
    idx = list(D30_TP_LAYERS)
    pick = lambda t: ({k: pick(v) for k, v in t.items()} if isinstance(t, dict)
                      else t[idx].contiguous())
    return {k: (pick(v) if k == "blocks" else v) for k, v in tree.items()}


def _d30_joint(torch, model, vqvae, params, vq_params):
    """The d30 joint sampler at B=8 (stacked cache, 2-way CFG 4.0, top-k
    900, top-p 0.96) with its prepared params, and a call(seed) -> canvases."""
    from controlvar_tpu_torch.eval.stepwise import StepwiseJointSampler

    sampler = StepwiseJointSampler(model, vqvae)
    serve = sampler.prepare_params(params)
    labels, types = torch.arange(8), torch.arange(8) % 4
    return lambda seed: sampler(serve, vq_params, labels, types,
                                torch.Generator().manual_seed(seed))


def d30_tp_rank_main(rank: int, port: str, directory: str) -> None:
    """One rank of phase 28 (`python3 chip_smoke.py --d30-tp-rank RANK PORT
    DIR`): a gloo group of two on this card, make_mesh(model=2), this
    rank's shard of ControlVAR-d30 (init_params(0), gates raised); a joint
    call at B=8 with the ranks' generators seeded apart (K1/K2 counted, the
    ids saved), one on the one-device call's ids (each CFG branch's logits
    at scales 1 and 9 against that call's), then one train step at the d30
    recipe (K3/K4 counted) whose D30_TP_LAYERS params and gradients, gathered,
    rank 0 writes. Writes DIR/rank<RANK>.json."""
    import faulthandler
    import math

    import torch

    from controlvar_tpu_torch.config import VQVAEConfig
    from controlvar_tpu_torch.device import tree_map
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.ops.attention import (decode_attention, flash_attention,
                                                    flash_attention_bwd)
    from controlvar_tpu_torch.ops.sample_kernel import sample_top_k_top_p_bisect
    from controlvar_tpu_torch.parallel import distributed
    from controlvar_tpu_torch.parallel.mesh import make_mesh
    from controlvar_tpu_torch.parallel.tensor import gather_params, shard_params
    from controlvar_tpu_torch.train.train_step import ControlVARTrainStep, init_train_state

    # a rank that hangs in a collective prints where before its parent's limit
    faulthandler.dump_traceback_later(D30_TP_TIMEOUT_S - 30, exit=True)
    kernels = (decode_attention, sample_top_k_top_p_bisect, flash_attention, flash_attention_bwd)
    cfg, optim = d30_recipe()
    distributed.initialize(f"localhost:{port}", 2, rank, backend="gloo")
    mesh = make_mesh(model=2)
    t = time.perf_counter()
    model, vqvae = ControlVARModel(cfg, mesh=mesh), VQVAE(VQVAEConfig())
    whole = raise_gates(model.init_params(0))
    params = shard_params(mesh, whole, mesh.model_index, cfg)
    del whole
    torch.cuda.empty_cache()
    vq_params = vqvae.init_params(1)
    res = {"rank": rank, "mesh": [mesh.data, mesh.model, mesh.data_index, mesh.model_index],
           "heads": params["blocks"]["qkv_kernel"].shape[-1] // (3 * cfg.head_dim),
           "init_s": time.perf_counter() - t}
    print(f"phase 28 rank {rank}: init and shard {res['init_s']:.1f} s", flush=True)
    joint = _d30_joint(torch, model, vqvae, params, vq_params)
    ref = torch.load(os.path.join(directory, "joint_ref.pt"), weights_only=True)

    def call(seed, forced=None, branches=None):
        _reset(*kernels)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with _tp_recorded(torch, forced, branches) as (ids, logits):
            out = joint(seed)
        torch.cuda.synchronize()
        return time.perf_counter() - t, ids, logits, out, [k.launches for k in kernels[:2]]

    dt, ids, _, out, counts = call(12 + rank)  # the ranks' generators differ
    res.update(joint_s=dt, joint_counts=counts,
               canvases_ok=all(tuple(c.shape) == (8, 256, 256, 3) and bool(torch.isfinite(c).all())
                               and float(c.min()) >= 0.0 and float(c.max()) <= 1.0 for c in out))
    torch.save([x.cpu() for x in ids], os.path.join(directory, f"ids_rank{rank}.pt"))
    print(f"phase 28 rank {rank}: joint call {dt:.2f} s, (K1, K2) = {tuple(counts)}", flush=True)
    branches = {}
    dt_forced, _, logits, _, _ = call(11, ref["ids"], branches)
    rel = lambda a, b: float((a.float() - b.float()).norm() / b.float().norm())
    res["logits"] = {}
    for si, want in ref["branches"].items():
        per = [rel(a, b.cuda()) for a, b in zip(branches[si].split(8), want.split(8))]
        res["logits"][str(si)] = dict(branch_rel_l2=per,
                                      combined_rel_l2=rel(logits[si], ref["logits"][si].cuda()))
    res["joint_forced_s"] = dt_forced
    del joint, out, logits, branches
    torch.cuda.empty_cache()
    stepper = ControlVARTrainStep(model, vqvae, optim, max_steps=1000, warmup_steps=10)
    state = init_train_state(params, optim)
    batch = _pixel_batch(torch, 8, cfg.num_classes, 5)
    torch.cuda.reset_peak_memory_stats()
    _reset(*kernels)
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, aux = stepper.step(state, vq_params, batch, torch.Generator().manual_seed(6))
    torch.cuda.synchronize()
    res.update(step_s=time.perf_counter() - t, step_counts=[k.launches for k in kernels[2:]],
               loss=float(aux["loss"]), grad_norm=float(aux["grad_norm"]),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    res["finite"] = math.isfinite(res["loss"]) and math.isfinite(res["grad_norm"])
    print(f"phase 28 rank {rank}: train step {res['step_s']:.2f} s, (K3, K4) = "
          f"{tuple(res['step_counts'])}, peak allocated {res['peak_gib']:.2f} GiB", flush=True)
    grads = gather_params(mesh, _d30_subtree(tree_map(lambda x: x.grad, state.params)), cfg)
    after = gather_params(mesh, _d30_subtree(tree_map(lambda x: x.detach(), state.params)), cfg)
    if rank == 0:
        torch.save({"params": tree_map(lambda x: x.cpu(), after),
                    "grads": tree_map(lambda x: x.cpu(), grads)},
                   os.path.join(directory, "train_rank0.pt"))
    del grads, after, state, stepper
    distributed.shutdown()
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def d30_tp_phase(torch, smi: str):
    """Phase 28: ControlVAR-d30 over model = 2. The one-device joint call
    (its ids, and each CFG branch's logits at scales 1 and 9) and train step
    in this process, whose d30 tree is then freed; then two ranks of
    `d30_tp_rank_main` on this card in a gloo group, held to them. Returns
    the numbers."""
    import gc

    from controlvar_tpu_torch.config import VQVAEConfig
    from controlvar_tpu_torch.device import tree_map
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.train.param_groups import named_leaves
    from controlvar_tpu_torch.train.train_step import ControlVARTrainStep, init_train_state

    cfg, optim = d30_recipe()
    tmp = _scratch_dir()
    d = tmp.name
    t0 = time.time()
    model, vqvae = ControlVARModel(cfg), VQVAE(VQVAEConfig())
    params = raise_gates(model.init_params(0))
    vq_params = vqvae.init_params(1)
    joint = _d30_joint(torch, model, vqvae, params, vq_params)
    branches = {}
    with _tp_recorded(torch, branches=branches) as (ids, logits):
        joint(11)
    torch.save({"ids": [x.cpu() for x in ids],
                "logits": {k: v.cpu() for k, v in logits.items()},
                "branches": {k: v.cpu() for k, v in branches.items()}},
               os.path.join(d, "joint_ref.pt"))
    del joint, ids, logits, branches
    torch.cuda.empty_cache()
    stepper = ControlVARTrainStep(model, vqvae, optim, max_steps=1000, warmup_steps=10)
    state = init_train_state(params, optim)
    state, aux = stepper.step(state, vq_params, _pixel_batch(torch, 8, cfg.num_classes, 5),
                              torch.Generator().manual_seed(6))
    held = lambda fn: dict(named_leaves(tree_map(lambda x: x.cpu(), _d30_subtree(
        tree_map(fn, state.params)))))
    one = (float(aux["loss"]), float(aux["grad_norm"]), float(aux["lr"]),
           held(lambda x: x.detach()), held(lambda x: x.grad))
    del state, stepper, params, vq_params, model, vqvae, aux
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 28: one-device joint call and step in {time.time() - t0:.1f} s (loss "
          f"{one[0]:.6f}, grad_norm {one[1]:.6f}); the d30 tree freed, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB left allocated", flush=True)
    port = str(_free_port())
    t1 = time.time()
    logs = [os.path.join(d, f"rank{r}.log") for r in range(2)]
    procs = []
    for r in range(2):
        with open(logs[r], "w") as log:  # a file, not a pipe: no rank blocks on its output
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                           "--d30-tp-rank", str(r), port, d], stdout=log,
                                          stderr=subprocess.STDOUT, text=True))

    def tail(r):
        with open(logs[r]) as f:
            return f.read()[-6000:]

    try:
        for r, p in enumerate(procs):
            p.wait(timeout=max(1.0, D30_TP_TIMEOUT_S - (time.time() - t1)))
            if p.returncode != 0:
                print(tail(1 - r), "\n----\n", tail(r))
                fail(f"phase 28: rank {r} exited with {p.returncode}")
    except subprocess.TimeoutExpired:
        print(tail(0), "\n----\n", tail(1))
        fail(f"phase 28: a rank ran past {D30_TP_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks_s = time.time() - t1
    for r in range(2):
        with open(logs[r]) as f:
            print("\n".join(line for line in f.read().splitlines()
                            if line.startswith("phase 28") or "FAIL" in line))
    res = []
    for r in range(2):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            res.append(json.load(f))
    S, D = cfg.num_scales, cfg.depth
    step = _launches_per_step(D, "full")
    for r, x in enumerate(res):
        print(f"phase 28 rank {r}: mesh {tuple(x['mesh'])}, {x['heads']} heads; joint call "
              f"{x['joint_s']:.2f} s (K1, K2) = {tuple(x['joint_counts'])}; train step "
              f"{x['step_s']:.2f} s (K3, K4) = {tuple(x['step_counts'])}, loss {x['loss']:.6f} "
              f"grad_norm {x['grad_norm']:.6f}, peak allocated {x['peak_gib']:.2f} GiB")
        if x["mesh"] != [1, 2, 0, r] or x["heads"] != cfg.num_heads // 2:
            fail(f"phase 28 rank {r}: layout {x['mesh']}, {x['heads']} heads")
        if x["joint_counts"] != [D * S, S] or x["step_counts"] != list(step):
            fail(f"phase 28 rank {r}: launches (K1, K2) = {x['joint_counts']}, (K3, K4) = "
                 f"{x['step_counts']}")
        if not (x["canvases_ok"] and x["finite"]):
            fail(f"phase 28 rank {r}: a canvas or a loss is bad")
        for si, e in x["logits"].items():
            print(f"phase 28 rank {r}: joint logits at scale {si} vs one device: rel L2 of each "
                  f"CFG branch {', '.join(f'{v:.3e}' for v in e['branch_rel_l2'])} (limit "
                  f"{TP_LOGIT_REL_L2:g}); of the combined logits {e['combined_rel_l2']:.3e}")
            if not max(e["branch_rel_l2"]) <= TP_LOGIT_REL_L2:
                fail(f"phase 28 rank {r}: scale {si} branch logits rel L2 "
                     f"{max(e['branch_rel_l2']):.3e}")
    ids = [torch.load(os.path.join(d, f"ids_rank{r}.pt"), weights_only=True) for r in range(2)]
    if len(ids[0]) != S or not all(torch.equal(a, b) for a, b in zip(*ids)):
        fail("phase 28: the ranks drew different ids")
    print("phase 28: the joint call's ids equal on both ranks (generators seeded apart)")
    tp = torch.load(os.path.join(d, "train_rank0.pt"), weights_only=True)
    x = res[0]
    cuda = lambda t: {k: v.cuda() for k, v in t.items()}
    limits = _tp_step_limits(
        torch, f"phase 28 train step vs one device (layers {D30_TP_LAYERS} and every leaf "
        f"outside the blocks)", (one[0], one[1], one[2], cuda(one[3]), cuda(one[4])),
        (x["loss"], x["grad_norm"], None, cuda(dict(named_leaves(tp["params"]))),
         cuda(dict(named_leaves(tp["grads"])))))
    wall = time.time() - t0
    print(f"phase 28: {wall:.1f} s, the ranks {ranks_s:.1f} s with their start-up, on {smi}: two "
          f"ranks sharing one card over gloo, a correctness run, not TP speed")
    tmp.cleanup()
    torch.cuda.empty_cache()
    return dict(wall=wall, ranks=res, limits=limits)


def adaln_phase(torch, patch_nums, widths=(1024, 1920), rows=(4, 64), streams=(1, 2),
                served=(64, 2)):
    """The blocks' AdaLN kernels (`ops/adaln.py`) at every scale's tokens
    (`streams` streams of pn^2, so odd counts too) at each of `rows` rows and
    each of `widths`, bf16 and fp32 residuals: each output against a float64
    formula within one rounding to the residual dtype, and against its plain
    version (the eager chain) within the sum of the kernel's bound and the
    chain's (one half ulp a rounded term), which covers both builds (1 and 2
    tokens a block). Then each kernel's, its plain version's and its bound's
    ms at the serving path's final scale (`served` = (rows, streams): 64 rows
    x 512 tokens by default), and the three kernels' device ms summed over one
    call's scales (CUDA graphs) beside that sum's bound. Returns the
    kernels-line entries and {C: (ms, bound ms)} of that sum."""
    from controlvar_tpu_torch.ops import adaln
    from controlvar_tpu_torch.probes.decode_scales import graph_ms

    g = torch.Generator(device="cuda").manual_seed(3)
    # name: (call, plain, (bf16 (B, l, C) tensors read and written, fp32
    # modulation rows read, bf16 bias vectors read)), each read or written once
    norm_args = lambda i: (i["h"], i["s1"], i["sh1"], 1e-6)
    add_norm_args = lambda i: (i["h"], i["y"], i["b"], i["g1"], i["s2"], i["sh2"], 1e-6)
    add_args = lambda i: (i["h"], i["y"], i["b"], i["g2"])
    sites = {
        "adaln_norm": (lambda i: adaln.adaln_norm(*norm_args(i)),
                       lambda i: adaln.adaln_norm_plain(*norm_args(i)), (2, 2, 0)),
        "adaln_add_norm": (lambda i: adaln.adaln_add_norm(*add_norm_args(i)),
                           lambda i: adaln.adaln_add_norm_plain(*add_norm_args(i)), (4, 3, 1)),
        "adaln_add": (lambda i: adaln.adaln_add(*add_args(i)),
                      lambda i: adaln.adaln_add_plain(*add_args(i)), (3, 1, 1))}

    def site_bound(i, counts):
        n_rows, n_ada, n_bias = counts
        R, _, C = i["h"].shape
        return bound_ms(2 * n_rows * i["h"].numel() + 4 * n_ada * R * C + 2 * n_bias * C,
                        0.0, 1.0)

    def inputs(R, l, C, dtype=torch.bfloat16):
        """A layer's rows of all layers' modulations (the einsum's layout),
        cut as the blocks cut them; h with a mean a token."""
        ada = 0.3 * torch.randn(R, 2, 6, C, generator=g, device="cuda")
        ada[:, :, :2] += 1.0
        rows = ada.permute(1, 0, 2, 3)[1].unbind(1)
        h = torch.randn(R, l, C, generator=g, device="cuda")
        return dict(h=(h + 2.0 * torch.randn(R, l, 1, generator=g, device="cuda")).to(dtype),
                    y=(0.5 * torch.randn(R, l, C, generator=g, device="cuda")).to(dtype),
                    b=(0.1 * torch.randn(C, generator=g, device="cuda")).to(dtype),
                    **{k: r.reshape(R, 1, C) for k, r in zip(("g1", "g2", "s1", "s2", "sh1",
                                                               "sh2"), rows)})

    def norm64(x, s, sh):
        """float64 LN(x) (1 + s) + sh, and the magnitudes of the chain's two
        rounded terms (the modulated LN, the sum)."""
        x = x.double()
        x = x - x.mean(-1, keepdim=True)
        mod = x / torch.sqrt((x * x).mean(-1, keepdim=True) + 1e-6) * (s.double() + 1)
        out = mod + sh.double()
        return out, mod.abs() + out.abs()

    def add64(i, gate):
        """float64 h + g (y + b), and the magnitudes of the chain's rounded
        terms (the bias add, the gate, the sum)."""
        branch = (i["y"].double() + i["b"].double()) * gate.double()
        out = i["h"].double() + branch
        return out, 2.0 * branch.abs() + out.abs()

    def bound(want, mag, rel):
        return rel * mag + 4e-6 * want.abs().max()

    def check(name, i, label):
        """The kernel's outputs against the formula and the plain version;
        returns the largest error against the formula."""
        with torch.no_grad():
            got, plain = call_of[name](i), plain_of[name](i)
        got = got if isinstance(got, tuple) else (got,)
        plain = plain if isinstance(plain, tuple) else (plain,)
        rel = 2.0 ** -8 if i["h"].dtype == torch.bfloat16 else 1e-5
        # (kernel output, plain output, float64 of the kernel's input, the
        # magnitudes of the chain's rounded terms, float64 of the chain's own input)
        if name == "adaln_norm":
            want, mag = norm64(i["h"], i["s1"], i["sh1"])
            outs = [(got[0], plain[0], want, mag, want, mag)]
        elif name == "adaln_add":
            want, mag = add64(i, i["g2"])
            outs = [(got[0], plain[0], want, mag, want, mag)]
        else:
            want, mag = add64(i, i["g1"])
            # the kernel normalises h' as computed, the chain its rounded h'
            wn, mn = norm64(want, i["s2"], i["sh2"])
            pn, pm = norm64(plain[0], i["s2"], i["sh2"])
            outs = [(got[0], plain[0], want, mag, want, mag), (got[1], plain[1], wn, mn, pn, pm)]
        err = 0.0
        for k, (a, p, w, m, pw, pmag) in enumerate(outs):
            a, p = a.double(), p.double()
            bk, bp = bound(w, w.abs(), rel), bound(pw, pmag, rel)
            worst = float(((a - w).abs() / bk).max())
            err = max(err, float((a - w).abs().max()))
            if not (torch.isfinite(a).all() and worst <= 1.0):
                fail(f"{name} {label} output {k}: error {worst:.3f} of one rounding's bound")
            if not float(((p - pw).abs() / bp).max()) <= 1.0:
                fail(f"{name} {label} output {k}: the plain chain outside its roundings' bound")
            if pw is w and not bool(((a - p).abs() <= bk + bp).all()):
                fail(f"{name} {label} output {k}: kernel and plain chain differ by more than "
                     f"the sum of their bounds")
        return err

    call_of = {n: v[0] for n, v in sites.items()}
    plain_of = {n: v[1] for n, v in sites.items()}
    n_checked, errs = 0, {}
    for C in widths:
        for dtype in (torch.bfloat16, torch.float32):
            for R in rows:
                for pn in patch_nums:
                    for n_streams in streams:
                        i = inputs(R, n_streams * pn * pn, C, dtype)
                        for name in sites:
                            e = check(name, i, f"({R}, {n_streams * pn * pn}, {C}) {dtype}")
                            errs[(name, C)] = max(errs.get((name, C), 0.0), e)
                            n_checked += 1
                        del i
    print(f"AdaLN kernels: {n_checked} launches checked (every scale of {tuple(patch_nums)} "
          f"in {streams} streams of tokens at {rows} rows, C {widths}, bf16 and fp32) against "
          f"float64 within one rounding and against the plain chains within both bounds")

    (R, n_streams), entries, per_call = served, [], {}
    final = n_streams * patch_nums[-1] ** 2
    for C in widths:
        i = inputs(R, final, C)
        for name, (call, plain, counts) in sites.items():
            ms, plain_ms = cuda_ms(lambda: call(i), 20), cuda_ms(lambda: plain(i), 5)
            b_ms, b_by = site_bound(i, counts)
            err = errs[(name, C)]
            print(f"{name} ({R}, {final}, {C}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by}), max_abs_err {err:.3e} (all checked shapes)")
            entries.append(dict(name=f"{name} C{C}", route="cuda",
                                source="controlvar_tpu_torch/csrc/adaln.cu", replaces=None,
                                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, library_ms=None))
        # one layer's three launches at every scale, device time (CUDA graphs)
        t = b = 0.0
        for pn in patch_nums:
            j = inputs(R, n_streams * pn * pn, C)
            t += graph_ms(lambda: [call(j) for call, _, _ in sites.values()])
            b += sum(site_bound(j, counts)[0] for _, _, counts in sites.values())
        per_call[C] = (t, b)
        print(f"AdaLN kernels, one layer over a call's {len(patch_nums)} scales at {R} rows, "
              f"C {C}: {t:.4f} ms (times the depth a call), bound {b:.4f} ms")
    torch.cuda.empty_cache()
    return entries, per_call


def adaln_train_phase(torch, B=8, l=1360, C=1920, depth=30, eps=1e-6):
    """The AdaLN sites' backward kernels (A4-A6) at the d30 train step's
    (B, l, C) bf16, drop path on, a layer's strided modulation rows: each
    against its plain backward on the same values in float64 (h's and y's
    gradients within one rounding to bf16 plus 1e-5 of their largest, the
    row and bias gradients within 1e-4 relative L2), a second launch equal
    bit for bit; then each kernel's device ms (its launches: the kernel and
    the column sums; torch.profiler), its plain backward's (`*_bwd_plain`,
    fp32) and its byte bound's; then one layer's three sites forward,
    recompute and backward (torch.utils.checkpoint, as remat `full` runs
    them) through the eager chains under autograd and through the
    Functions, in device ms (host dispatch exceeds the Functions' device
    time at one layer). Returns the kernels-line entries and the layer's
    {route: ms}."""
    from torch.utils.checkpoint import checkpoint

    from controlvar_tpu_torch.ops import adaln
    from controlvar_tpu_torch.probes.decode_scales import kernel_split

    g = torch.Generator(device="cuda").manual_seed(5)
    dev = dict(device="cuda", generator=g)
    ada = 0.3 * torch.randn(B, 2, 6, C, **dev)      # two layers' rows, the einsum's layout
    ada[:, :, :2] += 1.0
    g1, g2, s1, s2, sh1, sh2 = (r.reshape(B, 1, C) for r in ada.permute(1, 0, 2, 3)[1].unbind(1))
    bf = lambda *shape, scale=1.0: (scale * torch.randn(*shape, **dev)).to(torch.bfloat16)
    h = (torch.randn(B, l, C, **dev) + 2.0 * torch.randn(B, l, 1, **dev)).to(torch.bfloat16)
    y, f = bf(B, l, C, scale=0.5), bf(B, l, C, scale=0.5)
    b1, b2 = (0.1 * torch.randn(C, **dev)).to(torch.bfloat16).float(), \
        (0.1 * torch.randn(C, **dev)).to(torch.bfloat16).float()
    keep = ((torch.arange(B, device="cuda") % 5 != 2).float() / 0.9).to(torch.bfloat16)
    d1, d2, d3 = bf(B, l, C), bf(B, l, C), bf(B, l, C)
    # name: (kernel call, plain call, names of the gradients, bf16 (B, l, C) tensors read and
    # written, fp32 rows read and written, fp32 (C,) vectors read and written)
    sites = {
        "adaln_norm": (lambda: adaln._norm_bwd_kernel(h, s1, d1, eps),
                       lambda t: adaln.adaln_norm_bwd_plain(*t(h, s1, d1), eps),
                       ("h", "scale", "shift"), 3, 3, 0),
        "adaln_add_norm": (lambda: adaln._add_norm_bwd_kernel(h, y, b1, g1, s2, d1, d2, eps, keep),
                           lambda t: adaln.adaln_add_norm_bwd_plain(*t(h, y, b1, g1, s2, d1, d2),
                                                                    eps, t(keep)[0]),
                           ("h", "y", "bias", "gate", "scale", "shift"), 6, 5, 2),
        "adaln_add": (lambda: adaln._add_bwd_kernel(f, b2, g2, d3, keep),
                      lambda t: adaln.adaln_add_bwd_plain(*t(f, b2, g2, d3), t(keep)[0]),
                      ("h", "f", "bias", "gate"), 3, 2, 2)}
    same = lambda *ts: ts
    f64 = lambda *ts: tuple(x.double() for x in ts)
    entries, errs = [], {}
    for name, (call, plain, grads, n_big, n_rows, n_vec) in sites.items():
        got, again = call(), call()
        want = plain(f64)
        err = 0.0
        for gname, a, b, w in zip(grads, got, again, want):
            if not torch.equal(a, b):
                fail(f"{name} backward: d{gname} differs between two launches")
            a, w = a.double(), w.double()
            if gname in ("h", "y", "f"):
                bound = 2.0 ** -8 * w.abs() + 1e-5 * w.abs().amax()
                worst = float(((a - w).abs() / bound).max())
                if not (torch.isfinite(a).all() and worst <= 1.0):
                    fail(f"{name} backward: d{gname} error {worst:.3f} of its bound")
            else:
                gap = float((a - w).norm() / w.norm())
                if not gap <= 1e-4:
                    fail(f"{name} backward: d{gname} relative L2 {gap:.3e} > 1e-4")
            err = max(err, float((a - w).abs().max()))
        errs[name] = err
        del got, again, want
        split = kernel_split(call, ("_bwd_kernel", "_bwd_sum", "_bwd_batch"), 20)
        ms, plain_ms = sum(split.values()), cuda_ms(lambda: plain(same), 5)
        b_ms, b_by = bound_ms(2 * n_big * h.numel() + 4 * n_rows * B * C + 4 * n_vec * C,
                              0.0, 1.0)
        print(f"{name} backward ({B}, {l}, {C}) bf16, drop path: kernels {ms:.4f} ms ("
              + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items()))
              + f"), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max_abs_err "
              f"{err:.3e} against float64, bit-equal across launches")
        entries.append(dict(name=f"{name}_bwd C{C}", route="cuda",
                            source="controlvar_tpu_torch/csrc/adaln.cu", replaces=None,
                            launches=depth, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # one layer's three sites under remat full: forward, recompute, backward
    leaves = dict(h=h, y=y, f=f, ada=ada, b1=b1, b2=b2)

    def layer_ms(norm, add_norm, add):
        x = {k: v.detach().clone().requires_grad_(True) for k, v in leaves.items()}
        g1, g2, s1, s2, sh1, sh2 = (r.reshape(B, 1, C)
                                    for r in x["ada"].permute(1, 0, 2, 3)[1].unbind(1))

        def body(h, y, f):
            hn1 = norm(h, s1, sh1, eps)
            h1, hn2 = add_norm(h, y, x["b1"], g1, s2, sh2, eps, keep)
            return hn1, hn2, add(h1, f, x["b2"], g2, keep)

        def step():
            for t in x.values():
                t.grad = None
            outs = checkpoint(body, x["h"], x["y"], x["f"], use_reentrant=False,
                              preserve_rng_state=False)
            torch.autograd.backward(outs, (d1, d2, d3))

        return sum(kernel_split(step, (), 10).values())

    _reset_adaln(adaln)
    layer = {"eager chains": layer_ms(adaln.adaln_norm_plain, adaln.adaln_add_norm_plain,
                                      adaln.adaln_add_plain)}
    if _adaln_launches(adaln) + _adaln_bwd_launches(adaln) != (0,) * 6:
        fail("AdaLN layer timing: the eager chains launched an AdaLN kernel")
    layer["Functions"] = layer_ms(adaln.adaln_norm, adaln.adaln_add_norm, adaln.adaln_add)
    runs = 11     # a warm-up and 10 timed
    if (_adaln_launches(adaln), _adaln_bwd_launches(adaln)) != ((2 * runs,) * 3, (runs,) * 3):
        fail(f"AdaLN layer timing: launches {_adaln_launches(adaln)} forward, "
             f"{_adaln_bwd_launches(adaln)} backward, expected {2 * runs} and {runs} a site")
    # forward twice (18 bytes an element of bf16 a pass) and backward (24, and the
    # 6 of autograd's sum of h's two gradients)
    b_ms = bound_ms(2 * (2 * 9 + 12 + 3) * h.numel(), 0.0, 1.0)[0]
    print(f"AdaLN sites, one d30 layer ({B}, {l}, {C}) bf16 forward + recompute + backward: "
          + ", ".join(f"{k} {v:.4f} ms ({depth * v:.2f} ms a {depth}-layer step)"
                      for k, v in layer.items())
          + f"; bound {b_ms:.4f} ms; {layer['eager chains'] / layer['Functions']:.2f}x")
    torch.cuda.empty_cache()
    return entries, layer


VAR_D36_PN = (1, 2, 3, 4, 6, 9, 13, 18, 24, 32)   # pn=512: 2,240 tokens


def d36_phase(torch):
    """VAR-d36 at 512x512 (FoundationVision/VAR's --depth=36 --saln=1
    --pn=512: C 2304, 36 heads of 64, cos_attn, shared AdaLN, V 4096, the
    2,240-token pyramid) at B = 16 labels, 32 CFG rows. K1 at every scale's
    (l, cur) (l up to 1024, cur up to 2,240) over a 32-row x 36-head stacked
    cache on cos_attn inputs (d30_kernel_phase's), timed at the final scale;
    the AdaLN kernels at C 2304 over the pyramid's tokens at 32 rows, bf16
    and fp32 (adaln_phase), timed at the final scale; K2 at every scale's
    16 pn^2 combined rows of V 4096 (16,384 at the last), top-k alone on
    every row and with top-p, greedy == argmax, timed at the last; then
    SamplingHarness.class_conditional (cfg 1.5 ramped, top-k 900, top-p
    0.96, gates raised), a warm-up and a timed call, each with K1, K2 and
    the AdaLN kernels counted from zero and held to depth x scales (K1,
    A1-A3) and scales (K2). Returns the kernels-line entries, each with the
    launches of the timed call, img/s and the calls' peak GiB."""
    import math

    from controlvar_tpu_torch.config import SampleConfig, VQVAEConfig, var_config_from_depth
    from controlvar_tpu_torch.eval.harness import SamplingHarness
    from controlvar_tpu_torch.models.var import VARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE
    from controlvar_tpu_torch.ops import adaln
    from controlvar_tpu_torch.ops.attention import decode_attention, decode_attention_plain
    from controlvar_tpu_torch.ops.sample_kernel import (gumbel_noise, kept_mask_plain,
                                                        sample_bisect_plain,
                                                        sample_top_k_top_p_bisect)

    cfg = var_config_from_depth(36, cos_attn=True, shared_aln=True, drop_path_rate=0.15,
                                patch_nums=VAR_D36_PN)
    B, D, S, H, hd, L = 16, cfg.depth, cfg.num_scales, cfg.num_heads, cfg.head_dim, cfg.seq_len
    R, dev, bf = 2 * B, "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(36)
    sm = torch.exp(torch.clamp(random_scale_mul(torch, (H,), 36), max=math.log(100.0))).to(dev)
    unit = lambda x: x / x.norm(dim=-1, keepdim=True)

    def rand_q(l):
        """The strided (R, H, l, hd) q view of a fused QKV output after
        cos_attn's normalisation and scale_mul."""
        x = torch.randn(R, l, 3, H, hd, generator=g, device=dev)
        x[:, :, 0] = unit(x[:, :, 0]) * sm[:, None]
        return x.to(bf).permute(2, 0, 3, 1, 4)[0]

    ck = unit(torch.randn(2, R, H, L, hd, generator=g, device=dev)).to(bf)
    cv = torch.randn(2, R, H, L, hd, generator=g, device=dev).to(bf)
    errs = []
    for si, (lo, cur) in enumerate(cfg.begin_ends):
        q, li = rand_q(cur - lo), si % 2
        kk, vv = ck[li, :, :, :cur], cv[li, :, :, :cur]
        errs.append(check_close(
            f"K1 d36 ({R} rows x {H} heads, cos_attn) l={cur - lo} cur={cur}",
            decode_attention(q, ck, cv, li, cur, 1.0), decode_attention_plain(q, kk, vv, 1.0),
            decode_attention_plain(q, kk, vv.abs(), 1.0)))
        del q, kk, vv
        torch.cuda.empty_cache()
    lo = cfg.begin_ends[-1][0]
    k1 = dict(name="decode_attention d36", route="cuda",
              source="controlvar_tpu_torch/csrc/decode_attention.cu",
              replaces="controlvar_tpu/ops/attention.py:403", max_abs_err=max(errs),
              **_k1_times(torch, f"d36 final scale ({R}, {H}, {L - lo}, {hd}) over {L} rows, "
                          f"cos_attn", rand_q(L - lo), ck, cv, 1, L, 1.0))
    del ck, cv
    torch.cuda.empty_cache()

    adaln_entries, _ = adaln_phase(torch, VAR_D36_PN, widths=(cfg.embed_dim,), rows=(R,),
                                   streams=(1,), served=(R, 1))

    V, top_k, top_p, n = cfg.vocab_size, 900, 0.96, B * VAR_D36_PN[-1] ** 2
    logits = 3.0 * torch.randn(n, V, generator=g, device=dev)
    logits[:, :8] += 10.0  # a peaked head, as CFG logits have
    noise = gumbel_noise((n, V), torch.Generator().manual_seed(37), dev)
    mismatch = 0.0
    for pn in VAR_D36_PN:
        m = B * pn * pn
        _k2_agree(f"d36 {pn}x{pn} scale", logits[:m], noise[:m], top_k, 0.0, True)
        mismatch = max(mismatch, _k2_agree(f"d36 {pn}x{pn} scale", logits[:m], noise[:m],
                                           top_k, top_p, False))
    gen = lambda seed: torch.Generator().manual_seed(seed)
    if not torch.equal(sample_top_k_top_p_bisect(logits, 1, 0.0, generator=gen(38)),
                       logits.argmax(-1)):
        fail("K2 d36: greedy draw differs from argmax")
    ms = cuda_ms(lambda: sample_top_k_top_p_bisect(logits, top_k, top_p, generator=gen(39)), 20)
    plain_ms = cuda_ms(lambda: sample_bisect_plain(logits, noise, top_k, top_p), 3)
    n_kept = float(kept_mask_plain(logits, top_k, top_p).sum())
    b_ms, b_by = _k2_bound(n, V, n_kept)
    print(f"K2 d36 final scale ({n}x{V}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}; {n_kept:.0f} kept logits)")
    k2 = dict(name="sample_top_k_top_p_bisect d36", route="cuda",
              source="controlvar_tpu_torch/csrc/sample_bisect.cu",
              replaces="controlvar_tpu/ops/sample_kernel.py:126", max_abs_err=mismatch, ms=ms,
              plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del logits, noise
    torch.cuda.empty_cache()

    t0 = time.time()
    model, vqvae = VARModel(cfg), VQVAE(VQVAEConfig(patch_nums=VAR_D36_PN))
    harness = SamplingHarness(model, vqvae, SampleConfig(cfg=(1.5,) * 3, top_k=top_k,
                                                         top_p=top_p))
    params = harness.prepare_params(raise_gates(model.init_params(0)))
    vq_params = vqvae.init_params(1)
    labels = torch.randint(0, cfg.num_classes, (B,), generator=gen(40))
    print(f"d36 path: params and ch-160 VQVAE built in {time.time() - t0:.1f} s")
    want = (D * S, S) + (D * S,) * len(ADALN_SITES)

    def call(seed):
        _reset(decode_attention, sample_top_k_top_p_bisect)
        _reset_adaln(adaln)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = harness.class_conditional(params, vq_params, labels, gen(seed))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        counts = ((decode_attention.launches, sample_top_k_top_p_bisect.launches)
                  + _adaln_launches(adaln))
        if counts != want:
            fail(f"d36 path: launches (K1, K2, {', '.join(ADALN_SITES)}) = {counts}, expected "
                 f"{want}")
        if tuple(out.shape) != (B, 512, 512, 3) or not torch.isfinite(out).all():
            fail(f"d36 path: bad images {tuple(out.shape)}")
        if float(out.min()) < 0.0 or float(out.max()) > 1.0:
            fail("d36 path: images outside [0, 1]")
        return dt, counts

    torch.cuda.reset_peak_memory_stats()
    dt_warm, _ = call(41)
    dt, counts = call(42)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"d36 path: warm-up call {dt_warm:.3f} s; timed call {dt:.4f} s for {B} images "
          f"= {B / dt:.3f} img/s; peak allocated {peak:.2f} GiB; launches K1={counts[0]} "
          f"K2={counts[1]} " + " ".join(f"{site}={c}" for site, c in zip(ADALN_SITES, counts[2:])))
    del params, vq_params, harness
    torch.cuda.empty_cache()
    k1["launches"], k2["launches"] = counts[:2]
    for e in adaln_entries:
        e["launches"] = dict(zip(ADALN_SITES, counts[2:]))[e["name"].split()[0]]
    return [k1, k2, *adaln_entries], B / dt, peak


def category(kernel_name: str) -> str:
    """The device-time category of a kernel (CATEGORIES), else "other"."""
    return next((c for c, keys in CATEGORIES if any(k in kernel_name for k in keys)), "other")


def device_profile(torch, fn, tag):
    """One profiled call of fn (which returns its own host-clock seconds):
    (device busy ms, wall ms, {category: device ms}). The union of device
    op spans is the busy time. Tables by device time and by host time go to
    chiprun_out/chip_smoke_profile_<tag>.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = fn() * 1e3
    spans, by_cat = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name == "Command Buffer Full":
            continue
        spans.append((e.time_range.start, e.time_range.end))
        cat = category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    avg = prof.key_averages()
    table = (avg.table(sort_by="cuda_time_total", row_limit=40) + "\n"
             + avg.table(sort_by="self_cpu_time_total", row_limit=40))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"chip_smoke_profile_{tag}.txt"), "w") as f:
        f.write(table)
    print(f"{tag} breakdown: {len(spans)} device ops")
    return busy / 1e3, wall, by_cat


def breakdown(torch, call, sample_only, tokenize, decode, dt_timed):
    """Where a serving call's time goes: host-clock phases, then one
    profiled call's device busy time, idle share and kernel time by
    category."""
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    _, t_tok = timed(tokenize)
    (fh_c, fh_i), t_gen = timed(sample_only)
    _, t_dec = timed(lambda: decode(torch.cat([fh_c, fh_i])))
    print(f"breakdown: tokenize {t_tok:.2f} ms; tokenize + 10 scales {t_gen:.2f} ms "
          f"(scales alone {t_gen - t_tok:.2f} ms); decode both canvases {t_dec:.2f} ms")
    busy, wall, by_cat = device_profile(torch, lambda: call(12)[0], "serve")
    print(f"breakdown: profiled call {wall:.2f} ms, device busy {busy:.2f} ms, "
          f"idle share {1 - busy / wall:.4f} of the profiled call, "
          f"{1 - busy / (dt_timed * 1e3):.4f} of the timed call")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"breakdown: {cat}: {ms:.2f} ms")


def main() -> None:
    t_start = time.time()
    if not os.path.isdir(os.path.join(ROOT, "controlvar_tpu_torch")):
        fail("controlvar_tpu_torch/ not found beside chip_smoke.py: run from a checkout")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--d30-tp-rank"]:
        rank, port, directory = sys.argv[2:5]
        d30_tp_rank_main(int(rank), port, directory)
        return
    if sys.argv[1:2] in (["--tp-rank"], ["--tp-modes-rank"]):
        rank, port, port_cli, directory = sys.argv[2:6]
        (tp_rank_main if sys.argv[1] == "--tp-rank" else tp_modes_rank_main)(
            int(rank), port, port_cli, directory)
        return
    from controlvar_tpu_torch.config import (VQVAEConfig, control_var_config_from_depth,
                                             var_config_from_depth)
    from controlvar_tpu_torch.ops import _build

    phase("environment")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    phase("build")
    t = time.time()
    reports = _build.build(["decode_attention", "sample_bisect", "flash_attention",
                            "decode_prefix", "decode_flat", "adaln"])
    print(f"built {sorted(reports) or 'nothing (cached)'} in {time.time() - t:.1f} s")
    for name, rep in reports.items():
        kernel = ""
        for line in rep.splitlines():
            entry = re.search(r"\d([a-z_]+_kernel)((?:I?L[bi]\d+E)*)", line)
            if "Compiling entry function" in line and entry:
                kernel = entry.group(1) + "<{}>".format(
                    ", ".join(re.findall(r"L[bi](\d+)E", entry.group(2)))).replace("<>", "")
            elif any(k in line for k in ("registers", "spill", "smem", "serialized")):
                print(f"  {name} {kernel}: {line.strip()}")

    profile = "--profile" in sys.argv[1:]
    cfg = control_var_config_from_depth(16, multi_cond=True)
    cfg24 = control_var_config_from_depth(24, multi_cond=True)
    # VAR-d16 with configs/train_var_imagenet_d16.yaml's drop path and cond drop
    var16 = var_config_from_depth(16, drop_path_rate=0.1, cond_drop_rate=0.1)
    # the separator and type_pos options: L = 1378, head vocab 4114
    sep16 = control_var_config_from_depth(16, multi_cond=True, separator=True, type_pos=True)
    phase("K1 decode attention vs plain")
    k1 = k1_phase(torch, cfg, cfg24, sep16)
    torch.cuda.empty_cache()
    phase("K2 bisection sampling vs plain")
    k2 = k2_phase(torch, cfg.vocab_size, cfg.patch_nums)
    phase("K3 flash attention and K4 backward vs plain")
    k3, k4 = flash_phase(torch, cfg, var16, sep16)
    phase("K5 prefix decode and K6 in-place decode vs plain")
    k5, k6 = prefix_phase(torch, cfg24)
    torch.cuda.empty_cache()
    var12, var13 = var_config_from_depth(12), var_config_from_depth(13)
    phase("K7 flat decode and K8 fused decode vs plain")
    k7, k8 = flat_fused_phase(torch, var12, var13)
    torch.cuda.empty_cache()
    phase("small-input reference")
    reference_phase(torch)
    phase("training path: ControlVAR-d16 train step, B=8")
    (k3["launches"], k4["launches"]), s_step, policies = train_path_phase(torch, cfg,
                                                                             profile)
    torch.cuda.empty_cache()
    phase("checkpoints: VAR-d16 and ch-160 VQVAE .pth round trip")
    var_params = ckpt_phase(torch, var16)
    phase("fine-tuning path: VAR-d16 -> ControlVAR-d16 surgery, LoRA r16 steps, B=8")
    lora_counts, lora_s, lora_peak = finetune_phase(torch, cfg, var_params, profile)
    torch.cuda.empty_cache()
    phase("VAR training path: VAR-d16 train step, B=8")
    var_counts, var_s, var_peak = var_train_phase(torch, var16, var_params, profile)
    del var_params
    torch.cuda.empty_cache()
    phase("serving path: ControlVAR-d16 control-conditioned generation, B=16")
    (k1["launches"], k2["launches"], *adaln_counts), img_s = main_path_phase(torch, cfg,
                                                                             profile)
    torch.cuda.empty_cache()
    phase("joint path: ControlVAR-d24 joint generation, B=8, three cache modes")
    joint = joint_path_phase(torch, cfg24, profile)
    k5["launches"] = joint["kv_window=2"][0][2]
    k6["launches"] = joint["inplace_decode"][0][3]
    torch.cuda.empty_cache()
    phase("VAR path: VAR-d12 class-conditional generation, B=64, stacked and fused caches")
    v12 = var_path_phase(torch, var12, {"stacked": {}, "kv_fused": dict(kv_fused=True)},
                         profile, timed_rounds=True)
    torch.cuda.empty_cache()
    phase("VAR path: VAR-d13 (13 heads of 64: the flat layout), B=64")
    v13 = var_path_phase(torch, var13, {"flat": {}}, profile, timed_rounds=False)
    k8["launches"] = v12["kv_fused"][0][3]
    k7["launches"] = v13["flat"][0][2]
    torch.cuda.empty_cache()
    phase("separator data path: synthetic data -> Loader -> pretokenize -> token shards -> "
          "ControlVAR-d16 separator/type_pos from-tokens train step, B=8")
    shard_rate, sep_s, sep_peak, sep_k34 = separator_data_phase(torch, sep16, profile)
    torch.cuda.empty_cache()
    phase("Trainer path: ControlVAR-d16 separator/type_pos from token shards, B=8, stop_after, "
          "resume, a world-size-1 NCCL step")
    tr_s, tr_saves, tr_spread, tr_k34 = trainer_phase(torch, sep16, VQVAEConfig())
    torch.cuda.empty_cache()
    phase("tokenizer training path: MaskVQVAE ch-160 256x256 B=8 fp32 G/D steps, LPIPS, "
          "PatchGAN; a tiny step against the CPU")
    tokenizer_reference(torch)
    tok_s, tok_peak, tok_nll = tokenizer_phase(torch, VQVAEConfig())
    torch.cuda.empty_cache()
    phase("separator joint path: StepwiseJointSampler, ControlVAR-d16 separator/type_pos, B=8")
    sep_img_s, sep_k12 = separator_joint_phase(torch, sep16)
    torch.cuda.empty_cache()
    phase("bidirectional training: ControlVAR-d16 bidirectional, B=8, both stream orders")
    bi_losses = bidirectional_phase(torch, control_var_config_from_depth(16, bidirectional=True))
    torch.cuda.empty_cache()
    phase("sample_cond_cfg vs StepwiseCondSampler: ControlVAR-d16 multi_cond, B=16")
    cond_model_phase(torch, cfg)
    torch.cuda.empty_cache()
    phase("shared_aln: VAR-d16 sampler (B=16) and train step (B=8)")
    sh_img_s, sh_s = shared_aln_phase(torch, var_config_from_depth(16, shared_aln=True))
    torch.cuda.empty_cache()
    phase("CLI: controlvar_tpu_torch.cli.main subcommands at ControlVAR-d16 / ch-160 width")
    cli_counts, cli_img_s, bare_img_s, png_share = cli_phase(torch, cfg)
    torch.cuda.empty_cache()
    phase("tensor parallelism: ControlVAR-d16 over model=2, two ranks on this card (gloo): "
          "the north-star call, the train step, train --model_axis 2")
    tp = tp_phase(torch, cfg, smi)
    phase("tensor parallelism, the other modes: ControlVAR-d16 with separator, type_pos, "
          "shared_aln and bidirectional, LoRA r16, from tokens with grad_accum 2, over model=2 "
          "on this card (gloo); train --model_axis 2 --lora 16 with the options")
    tp_modes = tp_modes_phase(torch, smi)
    torch.cuda.empty_cache()
    phase("the d30 paths: ControlVAR-d30 (cos_attn, 30 heads): kernels at its shapes, a small "
          "cos_attn reference, the train step, conditional and joint generation, cli train")
    d30 = d30_phase(torch, profile)
    torch.cuda.empty_cache()
    phase("parity: eval/parity.py and cli.main parity on the card against a stub reference of "
          "the port's modules on the CPU (ch-160 token streams, d16 logits)")
    par = parity_phase(torch, cfg)
    phase("ControlVAR-d30 over model=2: two ranks on this card (gloo), 15 heads each, a joint "
          "call and a train step against one device")
    d30_tp = d30_tp_phase(torch, smi)
    phase("the blocks' AdaLN kernels vs float64 and plain at every scale's tokens, 4 and 64 "
          "rows, C 1024 and 1920; timed at the final scale and summed over a call's scales")
    adaln_entries, adaln_call = adaln_phase(torch, cfg.patch_nums)
    phase("VAR-d36 at 512x512 (shared AdaLN, cos_attn, the 2,240-token pyramid): K1, the AdaLN "
          "kernels at C 2304 and K2 at its shapes, then SamplingHarness.class_conditional, B=16")
    d36_entries, d36_img_s, d36_peak = d36_phase(torch)
    phase("the AdaLN sites' backward kernels at the d30 train step's (8, 1360, 1920) bf16 vs "
          "float64 and plain; one layer's sites forward, recompute and backward, eager chains "
          "against the Functions")
    bwd_entries, bwd_layer = adaln_train_phase(torch)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    rates = lambda res: ", ".join(f"{mode} {r[1]:.3f} img/s" for mode, r in res.items())
    print(f"training path: {s_step:.4f} s/step ({8 / s_step:.3f} img/s); remat "
          + ", ".join(f"{r} {v[0]:.4f} s/step {v[1]:.2f} GiB K3 {v[2]}"
                      for r, v in policies.items())
          + f"; fine-tuning path (LoRA r16): {lora_s:.4f} s/step, {lora_peak:.2f} GiB, K3/K4 "
          f"{lora_counts[0]}/{lora_counts[1]} a step; VAR-d16 training path: {var_s:.4f} "
          f"s/step ({8 / var_s:.3f} img/s), {var_peak:.2f} GiB, K3/K4 {var_counts[0]}/"
          f"{var_counts[1]} a step; serving path: "
          f"{img_s:.3f} img/s; joint path: {rates(joint)}; VAR-d12: {rates(v12)}; VAR-d13: "
          f"{rates(v13)}; separator data path: pretokenize {shard_rate:.3f} samples/s, "
          f"separator/type_pos from-tokens step {sep_s:.4f} s/step, {sep_peak:.2f} GiB, K3/K4 "
          f"{sep_k34[0]}/{sep_k34[1]} a step; Trainer path: {tr_s:.4f} s/step, K3/K4 "
          f"{tr_k34[0]}/{tr_k34[1]} a step, run-to-run spread {tr_spread:.3e}, CheckpointIO.save "
          f"{', '.join(f'{x:.3f}' for x in tr_saves)} s; tokenizer training: {tok_s:.4f} s/step "
          f"(G+D), {tok_peak:.2f} GiB, nll {tok_nll[0]:.6f}, after the warm-up "
          f"{tok_nll[1]:.6f}, after the last step {tok_nll[-1]:.6f}; "
          f"separator joint: {sep_img_s:.3f} img/s, K1/K2 "
          f"{sep_k12[0]}/{sep_k12[1]} a call; bidirectional step losses {bi_losses[0]:.5f} / "
          f"{bi_losses[1]:.5f}; shared_aln VAR-d16: {sh_img_s:.3f} img/s, {sh_s:.4f} s/step; "
          f"CLI eval-cond: {cli_img_s:.3f} img/s (bare harness {bare_img_s:.3f}), PNG share "
          f"{png_share:.3f} of its loop; CLI launches {json.dumps(cli_counts)}; tensor-parallel "
          f"d16 (model=2, two ranks sharing one card over gloo: a correctness run, not TP "
          f"speed): {tp['img_s']:.3f} img/s, {tp['s_step']:.4f} s/step, launches a rank "
          f"(K1, K2, K3, K4) {tuple(tp['counts'])} on")
    print(smi)
    tp_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    print("tensor-parallel rank shape (8 of 16 heads): " + json.dumps(
        {e["name"]: {k: e["tp_rank"][k] for k in tp_keys} for e in (k1, k3, k4)}))
    print("tensor-parallel separator rank shape (8 of 16 heads, L 1378; K1 at the joint "
          "path's final scale, 16 rows): " + json.dumps(
              {e["name"]: {k: e["tp_sep"][k] for k in tp_keys} for e in (k1, k3, k4)}))
    print("phase 25 launches a rank (K1, K2, K3, K4): " + json.dumps(tp_modes["counts"])
          + "; one device: " + json.dumps(tp_modes["one_counts"])
          + f"; phase {tp_modes['wall']:.1f} s")
    tr = d30["train"]
    print(f"d30 (cos_attn, 30 heads): train step {tr['s_step']:.4f} s/step "
          f"({8 / tr['s_step']:.3f} img/s), peak allocated {tr['peak']:.2f} GiB, reserved "
          f"{tr['reserved']:.2f} GiB, K3/K4 {tr['launches'][0]}/{tr['launches'][1]} a step, "
          f"init_params {tr['init_s']:.2f} s and {tr['init_gib']:.2f} GiB of host memory; "
          f"conditional B=16 {d30['cond'][0]:.3f} img/s at {d30['cond'][1]:.2f} GiB; joint B=8 "
          f"{d30['joint'][0]:.3f} img/s at {d30['joint'][1]:.2f} GiB; cli train (two steps, "
          f"init included) {d30['cli_s']:.2f} s; on")
    print(smi)
    print("d30 shapes (cos_attn, scale 1): " + json.dumps(d30["kernels"]))
    r0 = d30_tp["ranks"][0]
    print(f"parity (card vs CPU): token streams bitwise {par['tokens']['bitwise']} in "
          f"{par['t_tokens']:.1f} s, d16 logits max_abs_diff {par['logits']['max_abs_diff']:.3e} "
          f"in {par['t_logits']:.1f} s, CLI {par['t_cli']:.1f} s; d30 over model=2 (two ranks "
          f"sharing one card over gloo, a correctness run, not TP speed): joint call "
          f"{r0['joint_s']:.2f} s, train step {r0['step_s']:.2f} s, peak allocated "
          f"{r0['peak_gib']:.2f} GiB a rank, launches a rank (K1, K2, K3, K4) "
          f"{tuple(r0['joint_counts'] + r0['step_counts'])}, phase {d30_tp['wall']:.1f} s; on")
    print(smi)
    print(f"chip_smoke: the whole run {time.time() - t_start:.1f} s")
    print("AdaLN kernels, one layer over a call's scales at 64 rows (ms, bound ms): "
          + json.dumps(adaln_call))
    print(f"VAR-d36 512 class_conditional B=16: {d36_img_s:.3f} img/s, peak allocated "
          f"{d36_peak:.2f} GiB; its kernels' entries (name ... d36, C2304) carry that call's "
          f"launches; on")
    print(smi)
    print("AdaLN sites, one d30 layer forward + recompute + backward (ms): "
          + json.dumps(bwd_layer))
    for e in adaln_entries:   # the serving path's timed call, one a layer-step each
        e["launches"] = dict(zip(ADALN_SITES, adaln_counts))[e["name"].split()[0]]
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in (k1, k2, k3, k4, k5, k6, k7, k8, *adaln_entries,
                                            *d36_entries, *bwd_entries)]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
