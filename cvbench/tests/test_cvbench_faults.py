"""A run at the tiny size on the CPU (the look for a card skipped), with
the timed path broken underneath: `correct` comes out false for each fault
of `cvbench/faults.py` that the cells can have, and true without one."""
import pytest
import torch

from cvbench import faults, run
from cvbench.tests.tiny import tiny_cell

SEED = 3 * 2 ** 31 + 7


@pytest.fixture(autouse=True)
def threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def correct(workload, seconds=1.5):
    result, _, checks = run.run_cell(tiny_cell(workload), SEED, seconds, False, "cpu")
    return result["correct"], checks


@pytest.mark.parametrize("workload", ["d16_cond_b16", "d30_train_b8"])
def test_sound_run_is_correct(workload):
    ok, checks = correct(workload)
    assert ok, checks


@pytest.mark.parametrize("fault,number", [("drop_top_p", "draw_outside"),
                                           ("altered_token", "logit_mean")])
def test_sampling_fault(fault, number):
    with faults.FAULTS["sample"][fault]():
        ok, checks = correct("d16_cond_b16")
    assert not ok and checks[number]["value"] > checks[number]["limit"], checks


def test_state_unchanged():
    with faults.state_unchanged():
        ok, checks = correct("d30_train_b8")
    assert not ok and checks["change_gap"]["value"] > checks["change_gap"]["limit"]


def test_half_batch():
    with faults.half_batch():
        ok, checks = correct("d30_train_b8")
    assert not ok, checks
