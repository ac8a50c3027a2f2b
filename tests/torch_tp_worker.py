"""Worker of tests/test_torch_tp.py: one rank of a tensor-parallel run of
the port on the CPU.

    python tests/torch_tp_worker.py RANK WORLD MODEL PORT DIR [CLI_PORT]

The rank joins a gloo group of WORLD processes through COORDINATOR_ADDRESS,
NUM_PROCESSES and PROCESS_ID, lays it out as make_mesh(model=MODEL) and
reads DIR/inputs.pt (whole fp32 params made by from_jax_params, the VQVAE,
the batches and the forced ids). On its shard of the params it runs:
  - greedy sample_joint_cfg (every scale's ids, the f_hats);
  - greedy StepwiseCondSampler(force="control") on the forced ids, and
    the model-level sample_cond_cfg on them;
  - with WORLD == MODEL: a top-k 8 / top-p 0.9 joint draw (each rank's
    ids); one fp32 ControlVARTrainStep step with cond drop and drop path on
    (its clipped gradients too);
    and the Trainer(model_axis=MODEL) checkpoint runs: steps 1 and 2 from
    scratch into DIR/tp_ckpt (the second by a fresh Trainer that resumes),
    and step 2 resumed from the single-device checkpoint in DIR/one_to_tp;
  - one fp32 ControlVARTrainStep step at lr 1e-2 with no random draws, its
    rows the data index's shard of the batch.
Writes DIR/rank<RANK>_of<WORLD>.pt: the draws, the gathered params after
each step (gather_params), this rank's whole leaves, loss and grad_norm.
Given CLI_PORT, it then leaves the group and runs `cli.main train
--model_axis MODEL` (depth 2, two steps, --ckpt_dir DIR/cli_ckpt), which
joins a new group on CLI_PORT from the environment.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from controlvar_tpu_torch.config import ControlVARConfig, OptimConfig, VQVAEConfig  # noqa: E402
from controlvar_tpu_torch.device import tree_map  # noqa: E402
from controlvar_tpu_torch.eval import stepwise  # noqa: E402
from controlvar_tpu_torch.eval.harness import SamplingHarness  # noqa: E402
from controlvar_tpu_torch.models.control_var import ControlVARModel  # noqa: E402
from controlvar_tpu_torch.models.vqvae import VQVAE  # noqa: E402
from controlvar_tpu_torch.parallel import distributed  # noqa: E402
from controlvar_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from controlvar_tpu_torch.parallel.tensor import (gather_params, leaf_split,  # noqa: E402
                                                  shard_params)
from controlvar_tpu_torch.train.param_groups import named_leaves  # noqa: E402
from controlvar_tpu_torch.train.train_step import ControlVARTrainStep  # noqa: E402
from controlvar_tpu_torch.train.train_step import init_train_state  # noqa: E402


class Fp32Step(ControlVARTrainStep):
    tokenize_dtype = torch.float32
    compute_dtype = torch.float32


def _flat(tree):
    return {k: v.detach().clone() for k, v in named_leaves(tree)}


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


def sample(inp, model, vqvae, params, out):
    vq = inp["vq_params"]
    calls = recorded_draws()
    fh = model.sample_joint_cfg(params, vqvae, vq, inp["labels"], inp["ct"],
                                torch.Generator().manual_seed(7), cfg_scale=2.0, top_k=1,
                                top_p=0.0, compute_dtype=torch.float32, decode_img=False)
    out["joint_ids"], out["joint_fh"] = list(calls), [t.clone() for t in fh]
    calls.clear()
    harness = SamplingHarness(model, vqvae, device="cpu")
    assert harness._cond_mask._tp is model.tp and harness._joint._tp is model.tp
    sampler = stepwise.StepwiseCondSampler(model, vqvae, cfg_scales=(2.0, 2.0, 2.0), top_k=1,
                                           top_p=0.0, device="cpu",
                                           compute_dtype=torch.float32)
    fh = sampler(params, vq, inp["labels"], inp["ct"], torch.Generator().manual_seed(8),
                 inp["forced"], decode_img=False)
    out["cond_ids"], out["cond_fh"] = list(calls), [t.clone() for t in fh]
    calls.clear()
    fh = model.sample_cond_cfg(params, vqvae, vq, inp["labels"], inp["ct"],
                               torch.Generator().manual_seed(8), cfg_scales=(2.0, 2.0, 2.0),
                               c_mask=inp["forced"], top_k=1, top_p=0.0,
                               compute_dtype=torch.float32, decode_img=False)
    out["cond_model_fh"] = [t.clone() for t in fh]
    if model.mesh.data == 1:
        # each rank draws from its generator; the broadcast makes them one
        model.sample_joint_cfg(params, vqvae, vq, inp["labels"], inp["ct"],
                               torch.Generator().manual_seed(3 + model.mesh.model_index),
                               cfg_scale=2.0, top_k=8, top_p=0.9,
                               compute_dtype=torch.float32, decode_img=False)
        out["random_ids"] = list(calls)


def train_step(inp, cfg, vqvae, mesh, params_full, batch, seed=None):
    """One fp32 step on this rank's shard: (gathered params, this rank's
    whole leaves, loss, grad_norm, gathered clipped gradients)."""
    model = ControlVARModel(cfg, device="cpu", mesh=mesh)
    optim = OptimConfig(base_lr=1e-2, total_batch_size=512, grad_clip=1.0)
    step = Fp32Step(model, vqvae, optim, max_steps=100, warmup_steps=1, device="cpu")
    state = init_train_state(shard_params(mesh, params_full, mesh.model_index, cfg), optim)
    rows = batch["cls"].shape[0] // mesh.data
    local = {k: v[mesh.data_index * rows:(mesh.data_index + 1) * rows] for k, v in batch.items()}
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    state, aux = step.step(state, inp["vq_params"], local, gen)
    whole = {k: v.detach().clone() for k, v in named_leaves(state.params)
             if leaf_split(k, cfg, mesh.model) is None}
    grads = gather_params(mesh, tree_map(lambda t: t.grad, state.params), cfg)
    return (_flat(gather_params(mesh, state.params, cfg)), whole, float(aux["loss"]),
            float(aux["grad_norm"]), _flat(grads))


def trainer_runs(inp, cfg, vq_cfg, mesh, directory, out):
    """Steps 1 and 2 of Trainer(model_axis) from scratch into tp_ckpt, the
    second by a fresh Trainer that resumes; then step 2 from the
    single-device checkpoint in one_to_tp."""
    from controlvar_tpu_torch.data.build import Loader
    from controlvar_tpu_torch.data.imagenetc import SyntheticControlDataset
    from controlvar_tpu_torch.train import trainer as trainer_mod

    trainer_mod.ControlVARTrainStep = Fp32Step
    ds = SyntheticControlDataset(image_size=64, num_classes=8, patch_nums=cfg.patch_nums,
                                 length=8)

    def run(ckpt_dir, stop_after):
        loader = Loader(ds, batch_size=2, shard_id=mesh.data_index, num_shards=mesh.data,
                        num_workers=1)
        tr = trainer_mod.Trainer(cfg, vq_cfg, OptimConfig(base_lr=1e-2, total_batch_size=512,
                                                          epochs=1),
                                 loader, inp["vq_params"], ckpt_dir=ckpt_dir,
                                 model_axis=mesh.model, stop_after=stop_after, log_every=1,
                                 log_fn=lambda m: None, device="cpu")
        state, epoch = tr.maybe_resume(tr.init_state(seed=1))
        return tr.fit(state, epoch)

    run(os.path.join(directory, "tp_ckpt"), 1)
    state = run(os.path.join(directory, "tp_ckpt"), 2)
    out["trainer_step"] = state.step
    run(os.path.join(directory, "one_to_tp"), 2)


def main() -> None:
    rank, world, model_axis, port, directory = (int(sys.argv[1]), int(sys.argv[2]),
                                                int(sys.argv[3]), sys.argv[4], sys.argv[5])
    os.environ.update(COORDINATOR_ADDRESS=f"localhost:{port}", NUM_PROCESSES=str(world),
                      PROCESS_ID=str(rank))
    distributed.initialize(device="cpu")
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(directory, "inputs.pt"), weights_only=True)
    cfg, vq_cfg = ControlVARConfig(**inp["cfg"]), VQVAEConfig(**inp["vq_cfg"])
    mesh = make_mesh(model=model_axis, cfg=cfg)
    assert (mesh.data_index, mesh.model_index) == (rank // model_axis, rank % model_axis)
    vqvae = VQVAE(vq_cfg, device="cpu")
    model = ControlVARModel(cfg, device="cpu", mesh=mesh)
    params = shard_params(mesh, inp["params"], mesh.model_index, cfg)
    out = {"mesh": (mesh.data, mesh.model, mesh.data_index, mesh.model_index),
           "heads": params["blocks"]["qkv_kernel"].shape[-1] // (3 * cfg.head_dim),
           "round_trip": _flat(gather_params(mesh, params, cfg))}
    sample(inp, model, vqvae, params, out)
    out["step"] = train_step(inp, cfg, vqvae, mesh, inp["params"], inp["batch"])
    if mesh.data == 1:
        drop_cfg = ControlVARConfig(**dict(inp["cfg"], cond_drop_rate=0.5,
                                           drop_path_rate=0.5))
        out["drop_step"] = train_step(inp, drop_cfg, vqvae, mesh, inp["params"], inp["batch"],
                                      seed=9)
        trainer_runs(inp, cfg, vq_cfg, mesh, directory, out)
    torch.save(out, os.path.join(directory, f"rank{rank}_of{world}.pt"))
    distributed.shutdown()
    if len(sys.argv) > 6:
        from controlvar_tpu_torch.cli import main as cli

        os.environ["COORDINATOR_ADDRESS"] = f"localhost:{sys.argv[6]}"
        cli.main(["train", "--depth", "2", "--vae_ch", "32", "--patch_nums", "1", "2", "4",
                  "--multi_cond", "--batch_size", "2", "--steps", "2", "--log_every", "1",
                  "--device", "cpu",
                  "--model_axis", str(model_axis), "--ckpt_dir",
                  os.path.join(directory, "cli_ckpt")])
        distributed.shutdown()


if __name__ == "__main__":
    main()
