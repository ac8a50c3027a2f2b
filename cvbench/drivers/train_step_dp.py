"""Data-parallel training over `ranks` processes, one a card: each rank
runs back-to-back `ControlVARTrainStep.step` calls at the configuration's
recipe (`drivers/train_step.py`) on its own pool of `pool` batches and its
own step generator, both seeded by its rank, inside one process group
(`controlvar_tpu_torch/parallel/distributed.py:initialize`, NCCL on the
card, gloo on the CPU). The step averages the gradients over the ranks
(`average_gradients`, in `cv/allreduce`) as a user's data-parallel run
does, so the ranks hold the same parameters.

Rank 0 is the harness's process: its set-up starts ranks 1 .. ranks-1 (this
file run as a script) and meets them in the group, and it takes the
window's clock, the peak memory and the profiled steps. Before each of its
steps after the checked ones, rank 0 broadcasts one int32 from a tensor
kept on the device (1: step, 0: stop); the other ranks wait for it and
stop at 0, which rank 0 sends in `release`. That is the only collective
that a user's run does not make.

The checked steps: rank 0's readings are those of the global batch (the
losses and the gradient are the ranks' means); each other rank writes its
tokenizer ids and a fingerprint of its parameters after them to a file,
which rank 0 reads in `check`: `rank_gap` counts the (rank, leaf) pairs
whose parameters are not bit-equal to rank 0's, and the reference trains
on the union of the ranks' batches with each rank's own draws
(`judge_dp.check_dp`).
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)      # run as a rank's script: import the harness

from cvbench import weights as W  # noqa: E402
from cvbench.drivers.train_step import Driver as SingleDriver  # noqa: E402

JOIN_SECONDS = 120          # a rank's exit after the group is left, at most


def fingerprint(params) -> List[List[int]]:
    """Two exact int64 sums of each fp32 leaf's bit patterns (read as int32):
    their sum, and the sum of the absolute differences of neighbours (which
    an exchange of elements moves), made on the leaf's device a row of its
    first axis at a time."""
    sums = []
    for _, t in W.named_leaves(params):
        rows = t.detach().reshape(t.shape[0], -1) if t.dim() > 1 else t.detach().reshape(1, -1)
        s = torch.zeros(2, dtype=torch.int64, device=t.device)
        for row in rows:
            v = row.contiguous().view(torch.int32).long()
            s[0] += v.sum()
            s[1] += (v[1:] - v[:-1]).abs().sum()
        sums.append(s)
    return torch.stack(sums).tolist()


class Driver(SingleDriver):
    kind = "train"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, rank: int = 0,
                 shared: Optional[str] = None):
        super().__init__(cfg, traffic, seed, device)
        self.rank, self.world = rank, traffic["ranks"]
        self.shared = shared            # the ranks' directory: the store, readings, logs
        self.workers: List[subprocess.Popen] = []
        self.serving = False

    # ---- each rank's inputs --------------------------------------------------------

    def _tag(self, name: str) -> str:
        return f"rank{self.rank}/{name}"

    def _batches(self):
        t, cfg, dev = self.traffic, self.cfg, self.device
        B, size = t["batch"], cfg["vqvae"]["image_size"]
        out = []
        for k in range(t["pool"]):
            cls, typ = W.labels_types(B, cfg["model"]["num_classes"], 4, self.seed,
                                      self._tag(f"batch{k}"), dev)
            out.append({"image": W.pixel_images(B, size, self.seed, self._tag(f"image{k}"), dev),
                        "mask": W.pixel_images(B, size, self.seed, self._tag(f"mask{k}"), dev),
                        "cls": cls, "type": typ})
        return out

    def _generator(self) -> torch.Generator:
        return rank_generator(self.seed, self.rank)

    # ---- the group -------------------------------------------------------------

    def _start_workers(self) -> None:
        """Ranks 1 .. world-1, each this file run as a script on its own card."""
        with open(os.path.join(self.shared, "cell.json"), "w") as f:
            json.dump(dict(cfg=self.cfg, traffic=self.traffic, seed=self.seed,
                           device=self.device.type, threads=torch.get_num_threads()), f)
        env = dict(os.environ, PYTHONPATH=ROOT)
        for r in range(1, self.world):
            with open(os.path.join(self.shared, f"rank{r}.log"), "w") as log:
                self.workers.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), self.shared, str(r)],
                    stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT))

    def _join_group(self) -> None:
        from controlvar_tpu_torch.parallel import distributed

        distributed.initialize(f"file://{os.path.join(self.shared, 'store')}", self.world,
                               self.rank, device=self.device)
        self._go = torch.ones(1, dtype=torch.int32, device=self.device)
        self._stop = torch.zeros(1, dtype=torch.int32, device=self.device)

    def setup(self) -> None:
        """Rank 0: the ranks' directory, the other ranks started, the group
        joined; then every rank: `train_step.Driver.setup` (the checked
        steps, all-reduced), and the readings of the other ranks written."""
        if self.rank == 0:
            self.shared = tempfile.mkdtemp(prefix="cvbench_dp_")
            self._start_workers()
        self._join_group()
        super().setup()
        self.readings["fingerprint"] = fingerprint(self.state.params)
        if self.rank:
            ids = [tuple([t.cpu() for t in chain] for chain in pair)
                   for pair in self.readings["ids"]]
            path = os.path.join(self.shared, f"rank{self.rank}.pt")
            torch.save(dict(ids=ids, fingerprint=self.readings["fingerprint"]), path + ".tmp")
            os.replace(path + ".tmp", path)
        self.serving = True

    def step(self) -> Dict:
        """Rank 0 after the checked steps: the step signal, then the step."""
        if self.rank == 0 and self.serving:
            self._signal(self._go)
        return super().step()

    def _signal(self, flag: torch.Tensor) -> None:
        import torch.distributed as dist

        dist.broadcast(flag, src=0)

    def follow(self) -> int:
        """Ranks 1 ..: steps until rank 0 signals the stop; returns them."""
        import torch.distributed as dist

        flag, steps = torch.empty(1, dtype=torch.int32, device=self.device), 0
        while True:
            dist.broadcast(flag, src=0)
            if int(flag.item()) == 0:
                return steps
            super().step()
            steps += 1

    def release(self) -> None:
        """Rank 0: the stop signal; every rank leaves the group together (an
        NCCL communicator's teardown waits for its peers); then rank 0 waits
        for the other ranks' exit and reads their readings and the steps
        each followed after the checked ones; the state freed."""
        from controlvar_tpu_torch.parallel import distributed

        if self.rank == 0:
            self._signal(self._stop)
            self._sync()
        distributed.shutdown()
        if self.rank == 0:
            self._join_workers()
            self.others = [torch.load(os.path.join(self.shared, f"rank{r}.pt"))
                           for r in range(1, self.world)]
            self.followed = []
            for r in range(1, self.world):
                with open(os.path.join(self.shared, f"rank{r}.steps")) as f:
                    self.followed.append(int(f.read()))
            shutil.rmtree(self.shared, ignore_errors=True)
        super().release()

    def _join_workers(self) -> None:
        deadline = time.monotonic() + JOIN_SECONDS
        for r, p in enumerate(self.workers, start=1):
            try:
                code = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                code = p.wait()
            if code != 0:
                with open(os.path.join(self.shared, f"rank{r}.log")) as f:
                    tail = f.read()[-3000:]
                raise RuntimeError(f"rank {r} exited with {code}:\n{tail}")

    # ---- correctness -------------------------------------------------------------

    def check(self, control: bool = False) -> Dict[str, float]:
        """The numbers of the checked steps: rank 0's readings with the other
        ranks' ids and fingerprints, or with control those of the
        reference in fp8 in the program's place (its own ids)."""
        from cvbench import judge_dp

        n = self.traffic["checked_steps"]
        batches = [rank_batches(self.cfg, self.traffic, self.seed, r, self.device)[:n]
                   for r in range(self.world)]
        return judge_dp.check_dp(
            self.cfg, self.seed, batches,
            lambda: [rank_generator(self.seed, r) for r in range(self.world)], self.device,
            self.readings, self.others, control)


def rank_generator(seed: int, rank: int) -> torch.Generator:
    """A rank's step generator (class and cond-type drop, drop path)."""
    return torch.Generator().manual_seed(W.sub_seed(seed, f"rank{rank}/step"))


def rank_batches(cfg: Dict, traffic: Dict, seed: int, rank: int, device):
    """The pool of a rank's batches, as its driver makes them."""
    drv = Driver(cfg, traffic, seed, device, rank=rank)
    return drv._batches()


def main(shared: str, rank: int) -> int:
    with open(os.path.join(shared, "cell.json")) as f:
        cell = json.load(f)
    device = f"cuda:{rank}" if cell["device"] == "cuda" else cell["device"]
    torch.set_num_threads(cell["threads"])      # rank 0's share of the host's cores
    drv = Driver(cell["cfg"], cell["traffic"], cell["seed"], device, rank=rank, shared=shared)
    drv.setup()
    steps = drv.follow()
    with open(os.path.join(shared, f"rank{rank}.steps"), "w") as f:
        f.write(str(steps))
    from controlvar_tpu_torch.parallel import distributed

    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
