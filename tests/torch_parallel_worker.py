"""Worker of tests/test_torch_parallel.py: one data-parallel step of the
port's Trainer on the CPU.

    python tests/torch_parallel_worker.py RANK WORLD PORT OUTDIR

With WORLD > 1 the rank joins a gloo process group through the same
environment variables as the JAX package's multi-host runs
(COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID) and its Loader reads
shard RANK of WORLD, B = 2 a rank; with WORLD = 1 there is no group and the
Loader reads the whole batch, B = 4. Either way one fp32 `Trainer.fit`
step of a tiny multi_cond ControlVAR on pixel batches whose ignore masks
are random, so the ranks' mask weights differ. Writes the params, the
logged metrics and the rank's ignore-mask weight to OUTDIR/rank<RANK>_of<WORLD>.npz.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from controlvar_tpu_torch.config import ControlVARConfig, OptimConfig, VQVAEConfig  # noqa: E402
from controlvar_tpu_torch.data.build import Loader  # noqa: E402
from controlvar_tpu_torch.data.imagenetc import SyntheticControlDataset  # noqa: E402
from controlvar_tpu_torch.parallel import distributed  # noqa: E402
from controlvar_tpu_torch.train import trainer as trainer_mod  # noqa: E402
from controlvar_tpu_torch.train.param_groups import named_leaves  # noqa: E402
from controlvar_tpu_torch.train.train_step import ControlVARTrainStep  # noqa: E402

VQ = dict(ch=32, patch_nums=(1, 2, 4), vocab_size=128)
TINY = dict(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 4), vocab_size=128,
            cvae=32, num_classes=8, mask_factor=2, multi_cond=True, cond_drop_rate=0.0)
GLOBAL_BATCH = 4


class WeightedSynthetic(SyntheticControlDataset):
    """SyntheticControlDataset with a random 0/1 ignore mask a sample."""

    def sample(self, index, rng):
        s = super().sample(index, rng)
        s["ignore_mask"] = (rng.random(s["ignore_mask"].shape) > 0.3).astype(np.float32)
        return s


class Fp32Step(ControlVARTrainStep):
    tokenize_dtype = torch.float32
    compute_dtype = torch.float32


def main() -> None:
    rank, world, port, outdir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if world > 1:
        os.environ.update(COORDINATOR_ADDRESS=f"localhost:{port}", NUM_PROCESSES=str(world),
                          PROCESS_ID=str(rank))
    distributed.initialize(device="cpu")
    assert (distributed.process_index(), distributed.process_count()) == (rank, world)
    torch.set_num_threads(2)
    ds = WeightedSynthetic(image_size=64, num_classes=8, patch_nums=VQ["patch_nums"], length=8)
    loader = Loader(ds, batch_size=GLOBAL_BATCH // world, shard_id=rank, num_shards=world,
                    num_workers=1)
    local = next(iter(loader.epoch(0)))
    logs = []
    trainer_mod.ControlVARTrainStep = Fp32Step
    from controlvar_tpu_torch.models.vqvae import VQVAE

    vq_params = VQVAE(VQVAEConfig(**VQ), device="cpu").init_params(0)
    tr = trainer_mod.Trainer(ControlVARConfig(**TINY), VQVAEConfig(**VQ),
                             OptimConfig(base_lr=1e-2, total_batch_size=512, epochs=1), loader,
                             vq_params, stop_after=1, log_every=1, log_fn=logs.append,
                             device="cpu")
    assert tr.mesh.data == world
    state = tr.fit(tr.init_state(seed=1))
    arrays = {f"param/{k}": v.detach().numpy() for k, v in named_leaves(state.params)}
    arrays["weight"] = np.float64(local["ignore_mask"].sum())
    np.savez(os.path.join(outdir, f"rank{rank}_of{world}.npz"), **arrays)
    with open(os.path.join(outdir, f"rank{rank}_of{world}.json"), "w") as f:
        json.dump({"logs": logs, "step": state.step}, f)
    distributed.shutdown()


if __name__ == "__main__":
    main()
