"""The control of `correct`: the reference in the program's place at fp8,
the step below the configurations' bf16, reads at least one number well
above the program's sound run on the same seed. At the tiny size: on the
CPU, and on the card (marked `card`) on three seeds, where the program runs
its kernels. The limits themselves are set from the cell-size readings of
`cvbench/calibrate.py` (PERF.md)."""
import pytest
import torch

from cvbench import spec
from cvbench.tests.tiny import card, tiny_cell  # noqa: F401  (the fixture)

WORKLOADS = ["d16_cond_b16", "d30_train_b8"]


def readings(workload, seed, device):
    cell = tiny_cell(workload)
    drv = spec.driver(cell.traffic).Driver(cell.config, cell.traffic, seed, device)
    drv.setup()
    if drv.kind == "sample":
        drv.window(1.5)
    drv.release()
    return drv.check(), drv.check(control=True)


def separated(program, control) -> float:
    """The largest ratio of a control number over the program's."""
    return max(control[k] / max(program[k], 1e-12) for k in program)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_separates_on_cpu(workload):
    torch.set_num_threads(2)
    program, control = readings(workload, 2 ** 32 + 5, "cpu")
    assert separated(program, control) >= 3.0, (program, control)


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("seed", [101, 2 ** 31 + 3, 3 * 10 ** 9 + 17])
def test_control_separates_on_card(card, workload, seed):  # noqa: F811
    program, control = readings(workload, seed, card)
    assert separated(program, control) >= 3.0, (program, control)
