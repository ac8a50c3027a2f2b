"""Command-line entry points of the PyTorch port.

The port of `controlvar_tpu/cli/main.py`: one CLI over the dataclass
configs, with the same subcommands, options, defaults and messages:

  python -m controlvar_tpu_torch.cli.main train     --depth 16 --data synthetic ...
  python -m controlvar_tpu_torch.cli.main sample    --depth 16 --ckpt d16.pth ...
  python -m controlvar_tpu_torch.cli.main eval-cond --depth 16 --ckpt d16.pth ...
  python -m controlvar_tpu_torch.cli.main fid       --depth 16 --out ./fid ...
  python -m controlvar_tpu_torch.cli.main tokenize  --vae_ckpt vae_ch160v4096z32.pth ...
  python -m controlvar_tpu_torch.cli.main parity    --depth 16 --ckpt d16.pth ...

`parity` holds the port against the upstream reference checkout that
CONTROLVAR_REFERENCE_ROOT names (`eval/parity.py`), on the same .pth files.

Every subcommand runs on `cuda` unless `--device cpu` is given (the one
option the port adds); without a GPU and without it, it raises. YAML
configs override the dataclass defaults and explicit flags override YAML
(the reference's two-pass precedence). `--config` needs pyyaml and the
image-file subcommands (`tokenize`, `recon`, `sample --cond_image`) need
PIL; both are imported only where used. PNGs are written with zlib.

`train --model_axis N` trains tensor parallel over N ranks a model of the
process group that --coordinator_address/--num_processes/--process_id (or
COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID) join, one process a
rank; DIST_BACKEND=gloo lets ranks share one card. --batch_size is per
data shard: the ranks of one model group read the same rows.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np


def _load_yaml(path: Optional[str]) -> dict:
    if not path:
        return {}
    try:
        import yaml
    except ImportError as e:
        raise SystemExit("--config requires pyyaml (not installed)") from e
    with open(path) as f:
        return yaml.safe_load(f) or {}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("controlvar_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--config", type=str, default=None, help="YAML overrides")
    common.add_argument("--depth", type=int, default=16)
    common.add_argument("--mask_type", type=str, default="interleave_append")
    common.add_argument("--multi_cond", action=argparse.BooleanOptionalAction,
                        default=True)
    # ControlVAR ablation flags (reference: train_control_var_hpu.py:100-108,
    # consumed at :593-595). All map 1:1 onto ControlVARConfig fields.
    common.add_argument("--bidirectional", action="store_true",
                        help="random control/image order per scale")
    common.add_argument("--separate_decoding", action="store_true",
                        help="per-segment sequential decoding masks")
    common.add_argument("--separator", action="store_true",
                        help="learned separator tokens between segments")
    common.add_argument("--type_pos", action="store_true",
                        help="control-vs-image type position embedding")
    common.add_argument("--indep", action="store_true",
                        help="independent intra-scale masking")
    common.add_argument("--uncond", action="store_true",
                        help="unconditional model: cond_drop_rate=1.1 "
                             "(reference :593)")
    common.add_argument("--drop_path_rate", type=float, default=None,
                        help="override the 0.1*depth/24 factory law")
    common.add_argument("--cond_drop_rate", type=float, default=None)
    common.add_argument("--num_classes", type=int, default=None)
    common.add_argument("--vae_ckpt", type=str, default=None, help=".pth tokenizer")
    common.add_argument("--ckpt", type=str, default=None, help=".pth model ckpt")
    common.add_argument("--seed", type=int, default=42)
    common.add_argument("--sampler", type=str, default=None,
                        choices=("auto", "sort", "bisect", "bisect_prng"),
                        help="token-draw route of every sampling path (default "
                             "'auto'): 'auto', 'bisect' and 'bisect_prng' draw "
                             "by the bisection kernel on the card, 'sort' by "
                             "one sort of the logits")
    common.add_argument("--kv_window", type=int, default=None,
                        help="LOSSY decode acceleration: keep only the "
                             "scale-0 sink + last N scales of KV "
                             "(scale-aware KV compression, PAPERS.md)")
    common.add_argument("--vae_ch", type=int, default=160,
                        help="tokenizer base width (smoke runs: 32)")
    # multi-process rendezvous (reference: dist.py:19-49,
    # train_control_var_hpu.py:411-418). All three default from the env
    # vars COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID; omit them for
    # a single process.
    common.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port of process 0 (multi-process runs)")
    common.add_argument("--num_processes", type=int, default=None,
                        help="number of participating processes")
    common.add_argument("--process_id", type=int, default=None,
                        help="this process's rank in [0, num_processes)")
    common.add_argument("--patch_nums", type=int, nargs="*", default=None,
                        help="override scale pyramid (smoke runs: 1 2 4)")
    common.add_argument("--device", type=str, default=None,
                        help="device to run on (default cuda; cpu runs the "
                             "plain PyTorch versions of the kernels)")

    t = sub.add_parser("train", parents=[common])
    t.add_argument("--data", type=str, default="synthetic")
    t.add_argument("--data_root", type=str, default=None)
    t.add_argument("--batch_size", type=int, default=8)
    t.add_argument("--epochs", type=int, default=30)
    t.add_argument("--lr", type=float, default=1e-4)
    t.add_argument("--wd", type=float, default=0.05)
    t.add_argument("--wd_end", type=float, default=None,
                   help="weight-decay anneal target (default: constant wd)")
    t.add_argument("--schedule", type=str, default="lin0")
    t.add_argument("--ckpt_dir", type=str, default=None)
    t.add_argument("--var_pretrained", type=str, default=None,
                   help="plain-VAR .pth for surgery init")
    t.add_argument("--interpos", action="store_true",
                   help="surgery: per-scale interleaved pos_1LC expansion "
                        "(reference: train_control_var_hpu.py:489-521)")
    t.add_argument("--mpos", action="store_true",
                   help="surgery: negate the second pos copy (reference :514)")
    t.add_argument("--model_axis", type=int, default=1)
    t.add_argument("--steps", type=int, default=None,
                   help="cap steps AND the lr horizon (smoke)")
    t.add_argument("--stop_after", type=int, default=None,
                   help="checkpoint-and-exit after N steps WITHOUT touching "
                        "the lr horizon (preemption simulation; resume "
                        "continues the schedule exactly)")
    t.add_argument("--lora", type=int, default=0,
                   help="LoRA rank; >0 fine-tunes only LoRA factors "
                        "(reference: train_control_var_hpu.py:449-470)")
    t.add_argument("--grad_accum", type=int, default=1,
                   help="microbatches per optimizer step")
    t.add_argument("--log_every", type=int, default=50,
                   help="steps between metric readbacks (reference "
                        "--log_interval)")
    t.add_argument("--save_every", type=int, default=None,
                   help="checkpoint every N steps (reference --save_interval)")
    t.add_argument("--profile_dir", type=str, default=None,
                   help="capture a torch.profiler trace of steps 10-13 here")
    t.add_argument("--num_workers", type=int, default=8,
                   help="host data-loader worker threads")
    t.add_argument("--token_shards", type=str, default=None,
                   help="glob over tokens_*.npz written by `pretokenize`: "
                        "train from PRE-TOKENIZED batches, skipping both "
                        "frozen VQVAE encoder passes per step (--data/"
                        "--batch_size are ignored — one shard = one batch)")

    tvar = sub.add_parser("train-var", parents=[common],
                          help="plain-VAR baseline training "
                               "(train_var_hpu.py equivalent)")
    tvar.add_argument("--data", type=str, default="synthetic")
    tvar.add_argument("--data_root", type=str, default=None)
    tvar.add_argument("--batch_size", type=int, default=8)
    tvar.add_argument("--epochs", type=int, default=1)
    tvar.add_argument("--lr", type=float, default=1e-4)
    tvar.add_argument("--wd", type=float, default=0.05)
    tvar.add_argument("--schedule", type=str, default="lin0")
    tvar.add_argument("--steps", type=int, default=None)
    tvar.add_argument("--ckpt_dir", type=str, default=None,
                      help="checkpoint/resume dir")
    tvar.add_argument("--save_every", type=int, default=None,
                      help="checkpoint every N steps (always saves at the end)")

    pr = sub.add_parser("parity", parents=[common],
                        help="token-stream / logits parity vs the PyTorch "
                             "reference on the SAME .pth weights")
    pr.add_argument("--images", type=str, nargs="*", default=None,
                    help="images for token-stream parity (requires --vae_ckpt)")
    pr.add_argument("--batch_size", type=int, default=2)
    pr.add_argument("--out", type=str, default=None, help="write JSON report")

    s = sub.add_parser("sample", parents=[common])
    s.add_argument("--batch_size", type=int, default=8)
    s.add_argument("--classes", type=int, nargs="*", default=None)
    s.add_argument("--cond_type", type=str, default="depth")
    s.add_argument("--cfg", type=float, nargs=3, default=(4.0, 4.0, 4.0))
    s.add_argument("--top_k", type=int, default=900)
    s.add_argument("--top_p", type=float, default=0.96)
    s.add_argument("--out", type=str, default="./samples")
    s.add_argument("--force", type=str, default="none",
                   choices=["none", "control", "image"],
                   help="teacher-force a stream: 'control' generates images "
                        "conditioned on --cond_image (the north-star mode); "
                        "'image' predicts the control for --cond_image "
                        "(reference: train_control_var_hpu.py:300-325)")
    s.add_argument("--cond_image", type=str, nargs="*", default=None,
                   help="condition image path(s) for --force, tiled to the batch")

    ec = sub.add_parser("eval-cond", parents=[common],
                        help="pixel-conditional validation loop: walk a val "
                             "split, teacher-force the control (or image) "
                             "stream, save generations under "
                             "cfg_{t1}_{t2}_{t3}_{cond}/ "
                             "(reference: train_control_var_hpu.py:339-364)")
    ec.add_argument("--data", type=str, default="synthetic")
    ec.add_argument("--data_root", type=str, default=None)
    ec.add_argument("--batch_size", type=int, default=8)
    ec.add_argument("--val_cond", type=str, default="depth",
                    choices=["mask", "canny", "depth", "normal"])
    ec.add_argument("--force", type=str, default="control",
                    choices=["control", "image"])
    ec.add_argument("--cfg", type=float, nargs=3, default=(6.0, 6.0, 6.0))
    ec.add_argument("--top_k", type=int, default=900)
    ec.add_argument("--top_p", type=float, default=0.96)
    ec.add_argument("--out", type=str, default="./val_cond")
    ec.add_argument("--decode_both", action="store_true",
                    help="decode BOTH canvases (reference dual-canvas "
                         "semantics); default decodes only the generated "
                         "one, about half the VQVAE epilogue")
    ec.add_argument("--shard_id", type=int, default=None,
                    help="default: the process rank")
    ec.add_argument("--num_shards", type=int, default=None,
                    help="default: the process count")
    ec.add_argument("--max_batches", type=int, default=None,
                    help="cap walked batches (smoke)")

    f = sub.add_parser("fid", parents=[common])
    f.add_argument("--out", type=str, default="./fid_images")
    f.add_argument("--batch_size", type=int, default=25)
    f.add_argument("--images_per_class", type=int, default=50)
    f.add_argument("--gen_classes", type=int, default=None,
                   help="generate only the first N classes (loop bound; "
                        "--num_classes rewires the MODEL's class table and "
                        "null-class index — not what you want with a ckpt)")
    f.add_argument("--shard_id", type=int, default=None,
                   help="default: the process rank")
    f.add_argument("--num_shards", type=int, default=None,
                   help="default: the process count")
    f.add_argument("--gibbs", type=int, default=0)

    v = sub.add_parser("tokenize", parents=[common])
    v.add_argument("--images", type=str, nargs="+")
    v.add_argument("--out", type=str, default="tokens.npz")

    r = sub.add_parser("recon", parents=[common],
                       help="per-scale reconstruction grid (infer_vae.py equivalent)")
    r.add_argument("--images", type=str, nargs="+")
    r.add_argument("--out", type=str, default="./recon")

    tv = sub.add_parser("train-vqvae", parents=[common],
                        help="tokenizer GAN training (train_vqvae.py equivalent)")
    tv.add_argument("--data", type=str, default="synthetic")
    tv.add_argument("--data_root", type=str, default=None)
    tv.add_argument("--batch_size", type=int, default=8)
    tv.add_argument("--epochs", type=int, default=1)
    tv.add_argument("--lr", type=float, default=1e-4)
    tv.add_argument("--disc_start", type=int, default=0)
    tv.add_argument("--steps", type=int, default=None)
    tv.add_argument("--dual", action="store_true",
                    help="dual-codebook MaskVQVAE training — the reference's "
                         "primary train_vqvae.py mode")
    tv.add_argument("--entropy_weight", type=float, default=0.0)
    tv.add_argument("--ckpt_dir", type=str, default=None,
                    help="checkpoint/resume dir (reference saves .pth in "
                         "train_vqvae.py:168)")
    tv.add_argument("--save_every", type=int, default=None,
                    help="checkpoint every N steps (always saves at the end)")

    ex = sub.add_parser("export", parents=[common],
                        help="export weights to a reference-compatible .pth "
                             "(inverse of the .pth importer; loads into the "
                             "reference models/var.py / control_var.py)")
    ex.add_argument("--ckpt_dir", type=str, default=None,
                    help="training checkpoint dir (else --ckpt .pth or "
                         "random weights are exported)")
    ex.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    ex.add_argument("--what", type=str, default="model",
                    choices=("model", "vqvae"),
                    help="export the transformer or a train-vqvae tokenizer")
    ex.add_argument("--out", type=str, default="exported.pth")

    pt = sub.add_parser("pretokenize", parents=[common],
                        help="offline tokenization into token shards")
    pt.add_argument("--data", type=str, default="synthetic")
    pt.add_argument("--data_root", type=str, default=None)
    pt.add_argument("--batch_size", type=int, default=32)
    pt.add_argument("--out", type=str, default="./token_shards")
    return p


def _configs(args):
    from controlvar_tpu_torch.config import VQVAEConfig, control_var_config_from_depth

    vq_kw = {"ch": args.vae_ch}
    model_kw = {}
    if args.patch_nums:
        vq_kw["patch_nums"] = tuple(args.patch_nums)
        model_kw["patch_nums"] = tuple(args.patch_nums)
    for k in ("bidirectional", "separate_decoding", "separator", "type_pos", "indep"):
        if getattr(args, k):
            model_kw[k] = True
    if args.drop_path_rate is not None:
        model_kw["drop_path_rate"] = args.drop_path_rate
    if args.num_classes is not None:
        model_kw["num_classes"] = args.num_classes
    if args.uncond:
        model_kw["cond_drop_rate"] = 1.1  # always-drop (reference :593)
    elif args.cond_drop_rate is not None:
        model_kw["cond_drop_rate"] = args.cond_drop_rate
    vq_cfg = VQVAEConfig(**vq_kw)
    cfg = control_var_config_from_depth(args.depth, mask_type=args.mask_type,
                                        multi_cond=args.multi_cond, **model_kw)
    return vq_cfg, cfg


def _resolve_ckpt(path_or_name: str) -> str:
    """Accept either a filesystem path or a known checkpoint NAME
    (e.g. `vae_ch160v4096z32`, `controlvar_d16`), downloading the latter
    into ~/.cache/controlvar_tpu (reference: losses/util.py:36-44)."""
    from controlvar_tpu_torch.ckpt.download import URL_MAP, get_ckpt_path

    if os.path.exists(path_or_name) or path_or_name not in URL_MAP:
        return path_or_name
    root = os.path.join(os.path.expanduser("~"), ".cache", "controlvar_tpu")
    return get_ckpt_path(path_or_name, root)


def _load_vqvae(args, vq_cfg):
    from controlvar_tpu_torch.models.vqvae import VQVAE

    vqvae = VQVAE(vq_cfg, device=args.device)
    if args.vae_ckpt:
        args.vae_ckpt = _resolve_ckpt(args.vae_ckpt)
        from controlvar_tpu_torch.ckpt.torch_import import (convert_vqvae_state_dict,
                                                            load_torch_state_dict)

        params = convert_vqvae_state_dict(load_torch_state_dict(args.vae_ckpt), vq_cfg,
                                          device=args.device)
    else:
        print("[warn] no --vae_ckpt: RANDOM tokenizer weights", file=sys.stderr)
        params = vqvae.init_params(0)
    return vqvae, params


def _load_model(args, cfg):
    from controlvar_tpu_torch.models.control_var import ControlVARModel

    model = ControlVARModel(cfg, device=args.device)
    if args.ckpt:
        args.ckpt = _resolve_ckpt(args.ckpt)
        from controlvar_tpu_torch.ckpt.torch_import import (convert_control_var_state_dict,
                                                            load_torch_state_dict)

        params = convert_control_var_state_dict(load_torch_state_dict(args.ckpt), cfg,
                                                device=args.device)
    else:
        print("[warn] no --ckpt: RANDOM model weights", file=sys.stderr)
        params = model.init_params(1)
    return model, params


def _harness(args, model, vqvae, **kw):
    from controlvar_tpu_torch.config import SampleConfig
    from controlvar_tpu_torch.eval.harness import SamplingHarness

    sc = SampleConfig(cfg=tuple(args.cfg), top_k=args.top_k, top_p=args.top_p,
                      seed=args.seed, kv_window=args.kv_window)
    return SamplingHarness(model, vqvae, sc, device=args.device,
                           sampler=args.sampler or "auto", **kw)


def _synthetic_kwargs(args, cfg, vq_cfg) -> dict:
    """Dataset kwargs: --data_root, and the synthetic split's shapes."""
    ds_kwargs = {"root": args.data_root} if args.data_root else {}
    if args.data == "synthetic":
        ds_kwargs.update(num_classes=cfg.num_classes, patch_nums=cfg.patch_nums,
                         image_size=vq_cfg.patch_nums[-1] * vq_cfg.downsample)
    return ds_kwargs


def _checkpoint_io(args):
    """(CheckpointIO of --ckpt_dir or None, save(state, epoch, final))."""
    if not args.ckpt_dir:
        return None, lambda state, epoch, final=False: None
    from controlvar_tpu_torch.ckpt.orbax_io import CheckpointIO

    io = CheckpointIO(args.ckpt_dir)
    last_saved = [-1]

    def save(state, epoch, final=False):
        step = int(state.step)
        if step != last_saved[0]:
            io.save(step, state, metadata={"epoch": epoch})
            last_saved[0] = step
        if final:
            io.wait()

    return io, save


def cmd_export(args):
    """Export weights to a reference-compatible .pth so a model trained here
    can be evaluated by the reference PyTorch stack (ckpt/torch_export.py)."""
    import torch

    from controlvar_tpu_torch.ckpt.torch_export import (export_control_var_state_dict,
                                                        save_torch_checkpoint)
    from controlvar_tpu_torch.device import tree_map

    vq_cfg, cfg = _configs(args)
    step, epoch = 0, 0
    state = None
    if args.ckpt_dir:
        from controlvar_tpu_torch.ckpt.orbax_io import CheckpointIO

        state, meta = CheckpointIO(args.ckpt_dir).restore_raw(args.step)
        if state is None:
            raise SystemExit(f"no checkpoint found under {args.ckpt_dir}")
        epoch = int((meta or {}).get("epoch", 0))
    as_tensors = lambda tree: tree_map(torch.as_tensor, tree)
    if args.what == "vqvae":
        from controlvar_tpu_torch.ckpt.torch_export import (export_mask_vqvae_state_dict,
                                                            export_vqvae_state_dict)

        usage = mask_usage = None
        if state is not None:
            if "vq_params" not in state:
                raise SystemExit("checkpoint has no vq_params: --what vqvae exports "
                                 "train-vqvae checkpoints")
            params, step = as_tensors(state["vq_params"]), int(state["step"])
            usage = state.get("usage")
            mask_usage = state.get("mask_usage")
        else:
            _, params = _load_vqvae(args, vq_cfg)
        if "mask_quantize" in params:  # dual-codebook MaskVQVAE checkpoint
            sd = export_mask_vqvae_state_dict(params, vq_cfg, usage=usage,
                                              mask_usage=mask_usage)
        else:
            sd = export_vqvae_state_dict(params, vq_cfg, usage=usage)
    else:
        if state is not None:
            params, step = as_tensors(state["params"]), int(state["step"])
            if params and all(isinstance(v, dict) and set(v) == {"A", "B"}
                              for v in params.values()):
                # LoRA fine-tune checkpoint: the state's params are the (A, B)
                # tree only — merge into the frozen base (--ckpt) for export
                from controlvar_tpu_torch.ckpt.lora import LoRAConfig, merge_lora

                rank = next(iter(params.values()))["A"].shape[-1]
                _, base = _load_model(args, cfg)
                params = merge_lora(base, tree_map(lambda t: t.to(args.device), params),
                                    LoRAConfig(rank=rank))
                print(f"merged LoRA rank-{rank} factors into the base")
        else:
            _, params = _load_model(args, cfg)
        sd = export_control_var_state_dict(params, cfg)
    save_torch_checkpoint(args.out, sd, step=step, epoch=epoch)
    print(f"wrote {args.out} ({len(sd)} tensors, step={step}, epoch={epoch})")


def cmd_train(args):
    from controlvar_tpu_torch.config import OptimConfig
    from controlvar_tpu_torch.data.build import Loader, create_dataset
    from controlvar_tpu_torch.parallel.mesh import data_shard
    from controlvar_tpu_torch.train.trainer import Trainer

    vq_cfg, cfg = _configs(args)
    _, vq_params = _load_vqvae(args, vq_cfg)
    # --batch_size is PER DATA SHARD: each data index loads a disjoint shard
    # of every epoch (the --model_axis ranks of one model group read the
    # same rows) and the lr scale uses the GLOBAL batch (reference:
    # train_control_var_hpu.py:569-574, 631-633)
    shard_id, num_shards = data_shard(args.model_axis)
    if args.token_shards:
        # pre-tokenized path: one shard file = one batch (written by
        # `pretokenize`); the per-process batch is whatever the shards carry
        from controlvar_tpu_torch.data.shards import TokenShardLoader, read_token_shard

        loader = TokenShardLoader(args.token_shards, seed=args.seed, shard_id=shard_id,
                                  num_shards=num_shards)
        per_proc_bs = int(read_token_shard(loader.paths[0])["cls"].shape[0])
    else:
        ds = create_dataset(args.data, **_synthetic_kwargs(args, cfg, vq_cfg))
        loader = Loader(ds, batch_size=args.batch_size, num_workers=args.num_workers,
                        shard_id=shard_id, num_shards=num_shards)
        per_proc_bs = args.batch_size
    optim = OptimConfig(base_lr=args.lr, weight_decay=args.wd, weight_decay_end=args.wd_end,
                        schedule=args.schedule, epochs=args.epochs,
                        total_batch_size=per_proc_bs * num_shards,
                        grad_accum=args.grad_accum)
    trainer = Trainer(cfg, vq_cfg, optim, loader, vq_params, ckpt_dir=args.ckpt_dir,
                      model_axis=args.model_axis, lora_rank=args.lora,
                      log_every=args.log_every, save_every_steps=args.save_every,
                      stop_after=args.stop_after, profile_dir=args.profile_dir,
                      from_tokens=bool(args.token_shards), device=args.device)
    base_params = None
    if args.var_pretrained:
        from controlvar_tpu_torch.ckpt.surgery import var_to_control_var
        from controlvar_tpu_torch.ckpt.torch_import import (convert_var_state_dict,
                                                            load_torch_state_dict)
        from controlvar_tpu_torch.config import var_config_from_depth

        var_cfg = var_config_from_depth(
            args.depth, **({"patch_nums": cfg.patch_nums} if args.patch_nums else {}))
        var_params = convert_var_state_dict(load_torch_state_dict(args.var_pretrained),
                                            var_cfg, device=args.device)
        fresh = trainer.model.init_params(args.seed)
        base_params = var_to_control_var(var_params, fresh, cfg,
                                         mode="interpos" if args.interpos else "concat",
                                         mpos=args.mpos)
    elif args.ckpt:
        _, base_params = _load_model(args, cfg)
    if args.steps is not None:
        trainer.set_max_steps(args.steps)  # smoke cap incl. the lr horizon
    state = trainer.init_state(args.seed, base_params=base_params)
    state, start_epoch = trainer.maybe_resume(state)
    trainer.fit(state, start_epoch)


def cmd_sample(args):
    import torch

    from controlvar_tpu_torch.data.imagenetc import COND_IDX
    from controlvar_tpu_torch.device import generator_for
    from controlvar_tpu_torch.eval.harness import _to_uint8
    from controlvar_tpu_torch.utils.tracker import write_png

    vq_cfg, cfg = _configs(args)
    vqvae, vq_params = _load_vqvae(args, vq_cfg)
    model, params = _load_model(args, cfg)
    h = _harness(args, model, vqvae)
    params = h.prepare_params(params)
    B = args.batch_size
    classes = args.classes or list(range(B))
    labels = torch.from_numpy(np.resize(classes, B).astype(np.int64))
    ct = torch.full((B,), COND_IDX[args.cond_type], dtype=torch.long)
    generator = generator_for(args.seed)
    if args.force == "none":
        img_c, img_i = h.joint(params, vq_params, labels, ct, generator)
        out_dir = args.out
    else:
        # north-star mode: a USER's condition image drives conditional
        # generation (reference: pix_cond_inference,
        # train_control_var_hpu.py:300-325)
        if not args.cond_image:
            raise SystemExit(f"--force {args.force} requires --cond_image")
        from controlvar_tpu_torch.data.transforms import read_image

        hw = vq_cfg.patch_nums[-1] * vq_cfg.downsample
        conds = np.stack([read_image(path, hw) for path in args.cond_image])
        conds = torch.from_numpy(conds[np.resize(np.arange(len(conds)), B)])
        fn = h.control_conditioned if args.force == "control" else h.image_conditioned
        img_c, img_i = fn(params, vq_params, labels, ct, generator, conds)
        t1, t2, t3 = args.cfg
        out_dir = os.path.join(args.out, f"cfg_{t1:g}_{t2:g}_{t3:g}_{args.cond_type}")
    os.makedirs(out_dir, exist_ok=True)
    arr_c, arr_i = _to_uint8(img_c), _to_uint8(img_i)
    for b in range(B):  # control above image
        write_png(os.path.join(out_dir, f"sample_{b}_cls{int(labels[b])}.png"),
                  np.concatenate([arr_c[b], arr_i[b]], axis=0))
    print(f"wrote {B} samples to {out_dir}")


def cmd_eval_cond(args):
    """Pixel-conditional validation loop over a dataset split
    (reference: validate() c_mask/c_img arm, train_control_var_hpu.py:339-364):
    teacher-forces the chosen stream from each batch and writes the GENERATED
    half as PNGs under {out}/cfg_{t1}_{t2}_{t3}_{val_cond}/{shard}/.

    Deliberate deviation: the reference saves the bottom (image) half of the
    stacked canvas unconditionally (train_control_var_hpu.py:358-360), which
    in c_img mode is just the VQVAE round-trip of the input — this saves the
    model's generated stream instead (image for --force control, control
    prediction for --force image)."""
    from controlvar_tpu_torch.data.build import Loader, create_dataset, to_device
    from controlvar_tpu_torch.device import generator_for
    from controlvar_tpu_torch.eval.harness import _to_uint8_async
    from controlvar_tpu_torch.eval.serving import pipelined_map
    from controlvar_tpu_torch.parallel import distributed as dist
    from controlvar_tpu_torch.utils.tracker import write_png

    vq_cfg, cfg = _configs(args)
    vqvae, vq_params = _load_vqvae(args, vq_cfg)
    model, params = _load_model(args, cfg)
    # production default: decode ONLY the generated canvas (the forced
    # stream is this loop's own input); --decode_both decodes both
    h = _harness(args, model, vqvae, decode_generated_only=not args.decode_both)
    params = h.prepare_params(params)

    ds_kwargs = _synthetic_kwargs(args, cfg, vq_cfg)
    if args.data != "synthetic":
        ds_kwargs["split"] = "val"
        if args.data == "imagenetc":  # only ImagenetC pins a val cond type
            ds_kwargs["val_cond"] = args.val_cond
    ds = create_dataset(args.data, **ds_kwargs)
    # unset shard flags follow the process rank
    if args.shard_id is None:
        args.shard_id = dist.process_index()
    if args.num_shards is None:
        args.num_shards = dist.process_count()
    # drop_last=False: an eval walk covers the whole split
    loader = Loader(ds, batch_size=args.batch_size, shuffle=False, shard_id=args.shard_id,
                    num_shards=args.num_shards, drop_last=False)

    t1, t2, t3 = args.cfg
    save_path = os.path.join(args.out, f"cfg_{t1:g}_{t2:g}_{t3:g}_{args.val_cond}",
                             str(args.shard_id))
    os.makedirs(save_path, exist_ok=True)
    fn = h.control_conditioned if args.force == "control" else h.image_conditioned

    def batches():
        for bi, batch in enumerate(loader.epoch(0)):
            if args.max_batches is not None and bi >= args.max_batches:
                return
            yield bi, batch

    def generate(item):
        bi, batch = item
        labels = to_device(batch["cls"].astype(np.int64), args.device)
        ct = to_device(batch["type"].astype(np.int64), args.device)
        src = batch["mask"] if args.force == "control" else batch["image"]
        img_c, img_i = fn(params, vq_params, labels, ct, generator_for(args.seed + bi),
                          to_device(src, args.device))
        # the generated stream: the other half is the teacher-forced input
        return _to_uint8_async(img_i if args.force == "control" else img_c)

    n = 0
    # the PNGs of batch i are written while the device finishes batch i+1
    for (bi, _), arr in pipelined_map(generate, batches()):
        arr = arr.numpy()
        for b in range(arr.shape[0]):
            write_png(os.path.join(save_path, f"{bi * args.batch_size + b}.png"), arr[b])
        n += arr.shape[0]
    print(f"wrote {n} images to {save_path}")


def cmd_fid(args):
    from controlvar_tpu_torch.eval.harness import SamplingHarness
    from controlvar_tpu_torch.parallel import distributed as dist

    vq_cfg, cfg = _configs(args)
    vqvae, vq_params = _load_vqvae(args, vq_cfg)
    model, params = _load_model(args, cfg)
    h = SamplingHarness(model, vqvae, device=args.device, sampler=args.sampler or "auto")
    params = h.prepare_params(params)
    if args.shard_id is None:
        args.shard_id = dist.process_index()
    if args.num_shards is None:
        args.num_shards = dist.process_count()
    n = h.generate_fid_set(params, vq_params, args.out, batch_size=args.batch_size,
                           images_per_class=args.images_per_class,
                           num_classes=args.gen_classes or cfg.num_classes,
                           shard_id=args.shard_id, num_shards=args.num_shards,
                           seed=args.seed, gibbs=args.gibbs)
    print(f"wrote {n} images to {args.out}")


def _read_images(args):
    """The --images files at 256², as one (N, 256, 256, 3) tensor on the
    device."""
    import torch

    from controlvar_tpu_torch.data.transforms import read_image

    return torch.from_numpy(np.stack([read_image(p, 256) for p in args.images])).to(
        args.device)


def cmd_tokenize(args):
    import torch

    vq_cfg, _ = _configs(args)
    vqvae, vq_params = _load_vqvae(args, vq_cfg)
    batch = _read_images(args)
    with torch.no_grad():
        ids = vqvae.img_to_ids(vq_params, batch)
    np.savez(args.out, **{f"scale_{i}": t.cpu().numpy().astype(np.int32)
                          for i, t in enumerate(ids)})
    print(f"tokenized {batch.shape[0]} images -> {args.out}")


def cmd_recon(args):
    """Per-scale VQVAE reconstruction visualization
    (reference: infer_vae.py:97-121)."""
    import torch

    from controlvar_tpu_torch.utils.tracker import write_png

    vq_cfg, _ = _configs(args)
    vqvae, vq_params = _load_vqvae(args, vq_cfg)
    batch = _read_images(args)
    with torch.no_grad():
        ms = [((m + 1) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy()
              for m in vqvae.img_to_ms_recon(vq_params, batch)]
    os.makedirs(args.out, exist_ok=True)
    for b in range(batch.shape[0]):
        write_png(os.path.join(args.out, f"recon_{b}.png"),
                  np.concatenate([m[b] for m in ms], axis=1))
    print(f"wrote {batch.shape[0]} per-scale grids to {args.out}")


def cmd_train_vqvae(args):
    """Tokenizer GAN training loop (reference: train_vqvae.py:105-158).
    --dual trains the dual-codebook MaskVQVAE on (image, mask) pairs — the
    reference's primary tokenizer-training mode."""
    from controlvar_tpu_torch.data.build import Loader, create_dataset
    from controlvar_tpu_torch.losses.vqperceptual import VQLPIPSWithDiscriminator
    from controlvar_tpu_torch.train.train_vqvae import MaskVQVAETrainStep, VQVAETrainStep

    vq_cfg, _ = _configs(args)
    ds_kwargs = {"root": args.data_root} if args.data_root else {}
    if args.data == "synthetic":
        ds_kwargs.update(patch_nums=vq_cfg.patch_nums,
                         image_size=vq_cfg.patch_nums[-1] * vq_cfg.downsample)
    ds = create_dataset(args.data, **ds_kwargs)
    loader = Loader(ds, batch_size=args.batch_size)
    loss = VQLPIPSWithDiscriminator(disc_start=args.disc_start)
    io, save = _checkpoint_io(args)

    if args.dual:
        from controlvar_tpu_torch.models.vqvae_mask import MaskVQVAE

        stepper = MaskVQVAETrainStep(MaskVQVAE(vq_cfg, device=args.device), loss, lr=args.lr,
                                     entropy_weight=args.entropy_weight)
    else:
        from controlvar_tpu_torch.models.vqvae import VQVAE

        stepper = VQVAETrainStep(VQVAE(vq_cfg, device=args.device), loss, lr=args.lr)
    state, lpips_params = stepper.init_state(args.seed)
    if io is not None and io.latest_step() is not None:
        state, _meta = io.restore(state)
        print(f"resumed train-vqvae at step {int(state.step)}", flush=True)
    n = int(state.step)
    epoch = 0
    for epoch in range(args.epochs):
        for batch in loader.epoch(epoch):
            if args.dual:
                state, gm, recons = stepper.g_step(state, lpips_params, batch["image"],
                                                   batch["mask"])
                state, dm = stepper.d_step(state, batch["image"], batch["mask"], *recons)
                line = (f"nll={float(gm['nll']):.4f} d_loss={float(dm['d_loss']):.4f} "
                        f"usage={float(gm['usage_pct']):.1f}% "
                        f"mask_usage={float(gm['mask_usage_pct']):.1f}% "
                        f"entropy={float(gm['entropy_reg']):.3f}")
            else:
                state, gm = stepper.g_step(state, lpips_params, batch["image"])
                state, dm = stepper.d_step(state, batch["image"])
                line = (f"g_loss={float(gm['nll']):.4f} d_loss={float(dm['d_loss']):.4f} "
                        f"d_weight={float(gm['d_weight']):.3f}")
            if n % 50 == 0:
                print(f"step {n} {line}", flush=True)
            n += 1
            if args.save_every and n % args.save_every == 0:
                save(state, epoch)
            if args.steps is not None and n >= args.steps:
                save(state, epoch, final=True)
                return
    save(state, epoch, final=True)


def cmd_train_var(args):
    """Plain-VAR baseline training (reference: train_var_hpu.py:121-206)."""
    from controlvar_tpu_torch.config import OptimConfig, var_config_from_depth
    from controlvar_tpu_torch.data.build import Loader, create_dataset
    from controlvar_tpu_torch.device import generator_for
    from controlvar_tpu_torch.models.var import VARModel
    from controlvar_tpu_torch.parallel import distributed as dist
    from controlvar_tpu_torch.train.train_step import VARTrainStep, init_train_state

    vq_cfg, _ = _configs(args)
    model_kw = {"patch_nums": tuple(args.patch_nums)} if args.patch_nums else {}
    if args.drop_path_rate is not None:
        model_kw["drop_path_rate"] = args.drop_path_rate
    if args.num_classes is not None:
        model_kw["num_classes"] = args.num_classes
    if args.uncond:
        model_kw["cond_drop_rate"] = 1.1
    elif args.cond_drop_rate is not None:
        model_kw["cond_drop_rate"] = args.cond_drop_rate
    cfg = var_config_from_depth(args.depth, **model_kw)
    vqvae, vq_params = _load_vqvae(args, vq_cfg)
    model = VARModel(cfg, device=args.device)
    params = model.init_params(args.seed)
    ds = create_dataset(args.data, **_synthetic_kwargs(args, cfg, vq_cfg))
    loader = Loader(ds, batch_size=args.batch_size, shard_id=dist.process_index(),
                    num_shards=dist.process_count())
    optim = OptimConfig(base_lr=args.lr, weight_decay=args.wd, schedule=args.schedule,
                        epochs=args.epochs,
                        total_batch_size=args.batch_size * dist.process_count())
    max_steps = args.steps or (args.epochs * loader.steps_per_epoch())
    stepper = VARTrainStep(model, vqvae, optim, max_steps,
                           max(1, int(optim.warmup_init_frac * max_steps)), device=args.device)
    state = init_train_state(params, optim)
    io, save = _checkpoint_io(args)
    if io is not None and io.latest_step() is not None:
        state, _meta = io.restore(state)
        print(f"resumed train-var at step {int(state.step)}", flush=True)
    n = int(state.step)
    epoch = 0
    for epoch in range(args.epochs):
        for batch in loader.epoch(epoch):
            state, m = stepper.step(state, vq_params,
                                    {"image": batch["image"], "cls": batch["cls"]},
                                    generator_for(n))
            if n % 50 == 0:
                print(f"step {n} loss={float(m['loss']):.4f} acc={float(m['acc']):.4f}",
                      flush=True)
            n += 1
            if args.save_every and n % args.save_every == 0:
                save(state, epoch)
            if args.steps is not None and n >= args.steps:
                save(state, epoch, final=True)
                return
    save(state, epoch, final=True)


def cmd_parity(args):
    """Numerical parity against the PyTorch reference on the same .pth
    weights (the BASELINE.md north-star acceptance check): the token
    streams of --images through --vae_ckpt, and the teacher-forced logits
    of --ckpt on seeded inputs of --batch_size rows."""
    import json

    from controlvar_tpu_torch.eval.parity import logits_parity, token_stream_parity

    report = {}
    if args.vae_ckpt and args.images:
        from controlvar_tpu_torch.data.transforms import read_image

        imgs = np.stack([read_image(p, 256) for p in args.images])
        pns = tuple(args.patch_nums) if args.patch_nums else (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)
        report["token_stream"] = token_stream_parity(args.vae_ckpt, imgs, pns,
                                                     device=args.device)
        print("token-stream:", report["token_stream"])
    if args.ckpt:
        rng = np.random.default_rng(args.seed)
        B = args.batch_size
        _, cfg = _configs(args)
        L_tf = cfg.seq_len - cfg.first_l
        report["logits"] = logits_parity(
            args.ckpt, args.depth,
            rng.integers(0, cfg.num_classes, (B,)).astype(np.int64),
            rng.integers(0, 4, (B,)).astype(np.int64),
            rng.standard_normal((B, L_tf, cfg.cvae)).astype(np.float32),
            device=args.device,
        )
        print("logits:", report["logits"])
    if not report:
        raise SystemExit("parity needs --vae_ckpt --images and/or --ckpt")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.out}")


def cmd_pretokenize(args):
    from controlvar_tpu_torch.data.build import Loader, create_dataset
    from controlvar_tpu_torch.data.shards import pretokenize

    vq_cfg, cfg = _configs(args)
    vqvae, vq_params = _load_vqvae(args, vq_cfg)
    ds = create_dataset(args.data, **_synthetic_kwargs(args, cfg, vq_cfg))
    loader = Loader(ds, batch_size=args.batch_size, shuffle=False)
    n = pretokenize(vqvae, vq_params, loader, args.out)
    print(f"wrote {n} token shards to {args.out}")


COMMANDS = {
    "train": cmd_train,
    "train-var": cmd_train_var,
    "sample": cmd_sample,
    "eval-cond": cmd_eval_cond,
    "fid": cmd_fid,
    "tokenize": cmd_tokenize,
    "export": cmd_export,
    "recon": cmd_recon,
    "train-vqvae": cmd_train_vqvae,
    "pretokenize": cmd_pretokenize,
    "parity": cmd_parity,
}


def parse_args(argv) -> argparse.Namespace:
    """The parsed flags, with the --config YAML's values for the flags that
    argv does not give (YAML overrides defaults; explicit flags win)."""
    args = build_parser().parse_args(argv)
    for k, v in _load_yaml(args.config).items():
        if hasattr(args, k) and f"--{k}" not in argv and f"--no-{k}" not in argv:
            setattr(args, k, v)
    return args


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = parse_args(argv)
    from controlvar_tpu_torch.device import resolve_device
    from controlvar_tpu_torch.parallel import distributed as dist

    # the GPU unless --device is given; raises without one
    args.device = resolve_device(args.device)
    # multi-process rendezvous; a no-op for a single process
    dist.initialize(coordinator_address=args.coordinator_address,
                    num_processes=args.num_processes, process_id=args.process_id,
                    device=args.device)
    COMMANDS[args.cmd](args)


if __name__ == "__main__":
    main()
