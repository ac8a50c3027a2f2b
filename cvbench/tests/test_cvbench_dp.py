"""The data-parallel training cell (`d30_train_b8_x4`) at the tiny size on
the CPU: its four ranks as gloo processes. After the checked steps every
rank holds rank 0's parameters bit for bit; rank 0's readings of those
steps are one process's steps over the union of the ranks' batches (the
same recipe in fp32, without the random drops, whose draws differ between
one generator and four); the other ranks follow rank 0's steps and stop
with it; a rank that keeps its own gradient shows in `rank_gap`, and a
rank that leaves out half its batch in `grad_gap`."""
import contextlib
import copy

import pytest
import torch

from cvbench import faults, run, spec
from cvbench.drivers.train_step import Driver as SingleDriver
from cvbench.tests.tiny import tiny_cell

WORKLOAD = "d30_train_b8_x4"


@pytest.fixture(autouse=True)
def threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_ranks_agree_follow_and_match_one_process():
    cell = tiny_cell(WORKLOAD)
    cfg = copy.deepcopy(cell.config)
    cfg["compute_dtype"] = "float32"
    cfg["model"].update(cond_drop_rate=0.0, drop_path_rate=0.0)
    drv = spec.driver(cell.traffic).Driver(cfg, cell.traffic, 17, "cpu")
    drv.setup()
    window = drv.window(1.0)
    drv.release()
    assert drv.followed == [window["units"]] * (cell.traffic["ranks"] - 1)
    assert all(p.returncode == 0 for p in drv.workers)
    assert all(o["fingerprint"] == drv.readings["fingerprint"] for o in drv.others)
    assert drv.check()["rank_gap"] == 0

    ranks = cell.traffic["ranks"]
    pools = [drv._batches() if r == 0 else
             spec.driver(cell.traffic).rank_batches(cfg, cell.traffic, 17, r, "cpu")
             for r in range(ranks)]
    union = [{k: torch.cat([p[i][k] for p in pools]) for k in pools[0][i]}
             for i in range(cell.traffic["pool"])]
    one = SingleDriver(cfg, dict(cell.traffic, batch=ranks * cell.traffic["batch"]), 17, "cpu")
    one._batches = lambda: union
    one.setup()
    want, got = one.readings, drv.readings
    assert got["losses"] == pytest.approx(want["losses"], rel=1e-5)
    for name, g in want["grad"].items():
        assert got["grad"][name] == pytest.approx(g, rel=1e-4, abs=1e-9), name
    for name, c in want["change"].items():
        assert got["change"][name] == pytest.approx(c, rel=1e-3, abs=1e-9), name


@contextlib.contextmanager
def local_gradients():
    """A rank that all-reduces its gradients (so that the collectives stay
    in step) and keeps its own: planted in rank 0 alone. (`faults.py`'s
    `state_unchanged` skips the all-reduce with the update, which leaves
    the ranks' collectives out of step: gloo aborts and NCCL waits.)"""
    from controlvar_tpu_torch.train import train_step

    average = train_step.average_gradients

    def kept(params, group=None):
        params = list(params)
        saved = [None if p.grad is None else p.grad.clone() for p in params]
        average(params, group)
        for p, g in zip(params, saved):
            if g is not None:
                p.grad.copy_(g)

    train_step.average_gradients = kept
    try:
        yield
    finally:
        train_step.average_gradients = average


@pytest.mark.parametrize("fault,number", [("local_gradients", "rank_gap"),
                                           ("half_batch", "grad_gap")])
def test_fault_in_rank_0(fault, number):
    plant = local_gradients if fault == "local_gradients" else faults.half_batch
    with plant():
        result, _, checks = run.run_cell(tiny_cell(WORKLOAD), 3 * 2 ** 31 + 7, 1.0, False,
                                         "cpu")
    assert not result["correct"] and checks[number]["value"] > checks[number]["limit"], checks
