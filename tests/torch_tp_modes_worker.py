"""Worker of tests/test_torch_tp_modes.py: one rank of a tensor-parallel run
of the Trainer's remaining model-axis modes of the port, on the CPU.

    python tests/torch_tp_modes_worker.py RANK WORLD PORT DIR [CLI_PORT x3]

The rank joins a gloo group of WORLD processes through COORDINATOR_ADDRESS,
NUM_PROCESSES and PROCESS_ID, lays it out as make_mesh(model=2) and reads
DIR/inputs.pt (whole fp32 params of each option's model, the LoRA base and
factors, the VQVAE, the batches and the forced ids). On its shards it runs:
  - for each option (separator, type_pos, shared_aln, bidirectional): one
    fp32 from-tokens ControlVARTrainStep step at lr 1e-2 with no random
    draws (bidirectional in the image-first order), its rows the data
    index's shard of the batch, and greedy sampling: sample_joint_cfg of
    the separator and type_pos models, StepwiseCondSampler(force="control")
    of the shared_aln and bidirectional ones;
  - one fp32 LoRA step over its shard of the base, from the whole factors
    of the inputs (every B random);
  - the separator model's from-tokens step with accum=2 and its pixel step
    with accum=2, both weighted by random ignore masks;
  - with WORLD == 4: the separator step and joint sampling again on
    make_mesh(model=4), where its 70-column head stays whole, and a
    bidirectional Trainer(model_axis=2) run of four steps that records the
    stream order each rank took;
  - with WORLD == 2: Trainer(model_axis=2, lora_rank=4) checkpoint runs:
    steps 1 and 2 from scratch into DIR/lora_ckpt (the second by a fresh
    Trainer that resumes), and step 2 resumed from the single-device LoRA
    checkpoint in DIR/one_to_tp_lora.
Writes DIR/rank<RANK>_of<WORLD>.pt. Given three CLI ports, it then leaves
the group and runs `cli.main train --model_axis 2` three times, each on a
new group: with --lora 4, with --separator --type_pos --bidirectional, and
with --separator --type_pos --token_shards DIR/shards/*.npz --grad_accum 2
(depth 2, two steps, --ckpt_dir DIR/cli_<name>).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from controlvar_tpu_torch.ckpt.lora import LoRAConfig  # noqa: E402
from controlvar_tpu_torch.config import ControlVARConfig, OptimConfig, VQVAEConfig  # noqa: E402
from controlvar_tpu_torch.device import tree_map  # noqa: E402
from controlvar_tpu_torch.eval import stepwise  # noqa: E402
from controlvar_tpu_torch.models.control_var import ControlVARModel  # noqa: E402
from controlvar_tpu_torch.models.vqvae import VQVAE  # noqa: E402
from controlvar_tpu_torch.parallel import distributed  # noqa: E402
from controlvar_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from controlvar_tpu_torch.parallel.tensor import (gather_params, leaf_split,  # noqa: E402
                                                  shard_params)
from controlvar_tpu_torch.train.param_groups import named_leaves  # noqa: E402
from controlvar_tpu_torch.train.train_step import (ControlVARTrainStep,  # noqa: E402
                                                   LoRAControlVARTrainStep, init_train_state)

OPTIM = dict(base_lr=1e-2, total_batch_size=512, grad_clip=1.0)


class Fp32Step(ControlVARTrainStep):
    """The fp32 step; records the stream order of every step it takes."""

    tokenize_dtype = torch.float32
    compute_dtype = torch.float32
    orders = []

    def step(self, state, vq_params, batch, generator=None, mask_first=True, *args, **kwargs):
        Fp32Step.orders.append(bool(mask_first))
        return super().step(state, vq_params, batch, generator, mask_first, *args, **kwargs)


def _flat(tree):
    return {k: v.detach().clone() for k, v in named_leaves(tree)}


def _rows(batch, mesh):
    """The data index's rows of a batch (lists of per-scale ids too)."""
    n = batch["cls"].shape[0] // mesh.data
    lo = mesh.data_index * n

    def cut(v):
        return [cut(t) for t in v] if isinstance(v, list) else v[lo: lo + n]

    return {k: cut(v) for k, v in batch.items()}


def recorded_draws():
    """The ids of every draw, as the sampler holds them after the
    broadcast."""
    calls = []
    orig = stepwise.tp_draw

    def spy(ids, tp):
        out = orig(ids, tp)
        calls.append(out.clone())
        return out

    stepwise.tp_draw = spy
    return calls


def sample(inp, option, model, vqvae, params):
    """Greedy draws and f_hats: the joint sampler of a separator or type_pos
    model, the conditional sampler of the others."""
    vq = inp["vq_params"]
    calls = recorded_draws()
    if option in ("separator", "type_pos"):
        fh = model.sample_joint_cfg(params, vqvae, vq, inp["labels"], inp["ct"],
                                    torch.Generator().manual_seed(7), cfg_scale=2.0, top_k=1,
                                    top_p=0.0, compute_dtype=torch.float32, decode_img=False)
    else:
        sampler = stepwise.StepwiseCondSampler(model, vqvae, cfg_scales=(2.0, 2.0, 2.0),
                                               top_k=1, top_p=0.0, device="cpu",
                                               compute_dtype=torch.float32)
        fh = sampler(params, vq, inp["labels"], inp["ct"], torch.Generator().manual_seed(8),
                     inp["forced"], decode_img=False)
    return [t.clone() for t in calls], [t.clone() for t in fh]


def train_step(inp, cfg, vqvae, mesh, params_full, batch, mask_first=True, from_tokens=True,
               accum=1):
    """One fp32 step on this rank's shard: (gathered params, this rank's
    whole leaves, loss, grad_norm, gathered clipped gradients)."""
    model = ControlVARModel(cfg, device="cpu", mesh=mesh)
    optim = OptimConfig(**OPTIM)
    step = Fp32Step(model, vqvae, optim, max_steps=100, warmup_steps=1, device="cpu")
    state = init_train_state(shard_params(mesh, params_full, mesh.model_index, cfg), optim)
    state, aux = step.step(state, inp["vq_params"], _rows(batch, mesh), None, mask_first,
                           from_tokens=from_tokens, accum=accum)
    whole = {k: v.detach().clone() for k, v in named_leaves(state.params)
             if leaf_split(k, cfg, mesh.model) is None}
    grads = gather_params(mesh, tree_map(lambda t: t.grad, state.params), cfg)
    return (_flat(gather_params(mesh, state.params, cfg)), whole, float(aux["loss"]),
            float(aux["grad_norm"]), _flat(grads))


def lora_step(inp, vqvae, mesh):
    """One fp32 LoRA step from the inputs' whole factors over this rank's
    shard of the base: (factors after it, their clipped gradients, loss,
    grad_norm, the base shard unchanged)."""
    cfg = ControlVARConfig(**inp["lora"]["cfg"])
    model = ControlVARModel(cfg, device="cpu", mesh=mesh)
    optim = OptimConfig(**OPTIM)
    step = LoRAControlVARTrainStep(
        Fp32Step(model, vqvae, optim, max_steps=100, warmup_steps=1, device="cpu"),
        LoRAConfig(rank=inp["lora"]["rank"]))
    whole = inp["lora"]["base"]
    state = step.init_lora_state(torch.Generator().manual_seed(0), whole, optim)
    with torch.no_grad():
        for key, ab in state.params.items():
            for f in ("A", "B"):
                ab[f].copy_(inp["lora"]["factors"][key][f])
    base = shard_params(mesh, whole, mesh.model_index, cfg)
    before = _flat(base)
    state, aux = step.step(state, base, inp["vq_params"], _rows(inp["tokens"], mesh),
                           from_tokens=True)
    grads = {k: v.grad.clone() for k, v in named_leaves(state.params)}
    unchanged = all(torch.equal(v, before[k]) and v.grad is None
                    for k, v in named_leaves(base))
    return _flat(state.params), grads, float(aux["loss"]), float(aux["grad_norm"]), unchanged


def _loader(cfg, mesh, length=8):
    from controlvar_tpu_torch.data.build import Loader
    from controlvar_tpu_torch.data.imagenetc import SyntheticControlDataset

    ds = SyntheticControlDataset(image_size=64, num_classes=8, patch_nums=cfg.patch_nums,
                                 length=length)
    return Loader(ds, batch_size=2, shard_id=mesh.data_index, num_shards=mesh.data,
                  num_workers=1)


def _trainer(inp, cfg, vq_cfg, mesh, ckpt_dir=None, stop_after=None, lora_rank=0, length=8):
    from controlvar_tpu_torch.train import trainer as trainer_mod

    trainer_mod.ControlVARTrainStep = Fp32Step
    tr = trainer_mod.Trainer(cfg, vq_cfg, OptimConfig(base_lr=1e-2, total_batch_size=512,
                                                      epochs=1),
                             _loader(cfg, mesh, length), inp["vq_params"], ckpt_dir=ckpt_dir,
                             model_axis=mesh.model, lora_rank=lora_rank, stop_after=stop_after,
                             log_every=1, log_fn=lambda m: None, device="cpu")
    state, epoch = tr.maybe_resume(tr.init_state(seed=1))
    return tr.fit(state, epoch)


def lora_trainer_runs(inp, vq_cfg, mesh, directory, out):
    """Steps 1 and 2 of Trainer(model_axis, lora_rank=4) from scratch into
    lora_ckpt, the second by a fresh Trainer that resumes; then step 2 from
    the single-device checkpoint in one_to_tp_lora."""
    cfg = ControlVARConfig(**inp["lora"]["cfg"])
    ckpt = os.path.join(directory, "lora_ckpt")
    _trainer(inp, cfg, vq_cfg, mesh, ckpt, 1, lora_rank=4)
    state = _trainer(inp, cfg, vq_cfg, mesh, ckpt, 2, lora_rank=4)
    out["lora_trainer"] = (state.step, _flat(state.params))
    _trainer(inp, cfg, vq_cfg, mesh, os.path.join(directory, "one_to_tp_lora"), 2, lora_rank=4)


def run_cli(directory, model_axis, ports) -> None:
    """`cli.main train --model_axis` with LoRA, with the options, and from
    token shards with grad_accum, each on a new group."""
    from controlvar_tpu_torch.cli import main as cli

    common = ["train", "--depth", "2", "--vae_ch", "32", "--patch_nums", "1", "2", "4",
              "--multi_cond", "--batch_size", "2", "--steps", "2", "--log_every", "1",
              "--device", "cpu", "--model_axis", str(model_axis)]
    runs = {"lora": ["--lora", "4"],
            "options": ["--separator", "--type_pos", "--bidirectional"],
            "tokens": ["--separator", "--type_pos", "--grad_accum", "2", "--token_shards",
                       os.path.join(directory, "shards", "*.npz")]}
    for (name, extra), port in zip(runs.items(), ports):
        os.environ["COORDINATOR_ADDRESS"] = f"localhost:{port}"
        print(f"cli run {name}", flush=True)
        cli.main(common + extra + ["--ckpt_dir", os.path.join(directory, f"cli_{name}")])
        distributed.shutdown()


def main() -> None:
    rank, world, port, directory = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                    sys.argv[4])
    os.environ.update(COORDINATOR_ADDRESS=f"localhost:{port}", NUM_PROCESSES=str(world),
                      PROCESS_ID=str(rank))
    distributed.initialize(device="cpu")
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(directory, "inputs.pt"), weights_only=True)
    vq_cfg = VQVAEConfig(**inp["vq_cfg"])
    vqvae = VQVAE(vq_cfg, device="cpu")
    mesh = make_mesh(model=2)
    assert (mesh.data_index, mesh.model_index) == (rank // 2, rank % 2)
    out = {"mesh": (mesh.data, mesh.model, mesh.data_index, mesh.model_index)}
    for option, kw in inp["cfgs"].items():
        cfg = ControlVARConfig(**kw)
        params_full = inp["params"][option]
        model = ControlVARModel(cfg, device="cpu", mesh=mesh)
        params = shard_params(mesh, params_full, mesh.model_index, cfg)
        out[f"sample/{option}"] = sample(inp, option, model, vqvae, params)
        out[f"step/{option}"] = train_step(inp, cfg, vqvae, mesh, params_full, inp["tokens"],
                                           mask_first=option != "bidirectional")
    sep = ControlVARConfig(**inp["cfgs"]["separator"])
    sep_params = inp["params"]["separator"]
    out["head_cols"] = shard_params(mesh, sep_params, mesh.model_index,
                                    sep)["head"]["kernel"].shape[-1]
    out["accum/tokens"] = train_step(inp, sep, vqvae, mesh, sep_params, inp["tokens_ign"],
                                     accum=2)
    out["accum/pixels"] = train_step(inp, sep, vqvae, mesh, sep_params, inp["pixels_ign"],
                                     from_tokens=False, accum=2)
    out["lora"] = lora_step(inp, vqvae, mesh)
    if world == 4:
        mesh4 = make_mesh(model=4, cfg=sep)
        model = ControlVARModel(sep, device="cpu", mesh=mesh4)
        params = shard_params(mesh4, sep_params, mesh4.model_index, sep)
        out["head_cols4"] = params["head"]["kernel"].shape[-1]
        out["sample4/separator"] = sample(inp, "separator", model, vqvae, params)
        out["step4/separator"] = train_step(inp, sep, vqvae, mesh4, sep_params, inp["tokens"])
        Fp32Step.orders.clear()
        _trainer(inp, ControlVARConfig(**inp["cfgs"]["bidirectional"]), vq_cfg, mesh,
                 length=16)
        out["orders"] = list(Fp32Step.orders)
    else:
        lora_trainer_runs(inp, vq_cfg, mesh, directory, out)
    torch.save(out, os.path.join(directory, f"rank{rank}_of{world}.pt"))
    distributed.shutdown()
    if len(sys.argv) > 5:
        run_cli(directory, 2, sys.argv[5:8])


if __name__ == "__main__":
    main()
