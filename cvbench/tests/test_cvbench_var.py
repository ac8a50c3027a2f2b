"""The plain VAR cell (`var_d36_512_b16`) at the tiny size on the CPU: the
counts of `counts_var.py` against hand counts, the reference
(`reference/var.py`) against the port's teacher-forced forward with shared
AdaLN, the result line, and the faults that must turn `correct` false."""
import json

import pytest
import torch

from cvbench import counts, counts_var, faults, run, spec
from cvbench import weights_var as WV
from cvbench.reference import var as rv
from cvbench.reference.prec import Prec, exact
from cvbench.tests.tiny import tiny_cell

WORKLOAD = "var_d36_512_b16"
SEED = 3 * 2 ** 31 + 7
M = dict(depth=1, embed_dim=4, num_heads=2, mlp_ratio=4.0, vocab_size=8, cvae=2,
         patch_nums=[1, 2])
V = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, z_channels=4, quant_conv_ks=3, image_size=8)


@pytest.fixture(autouse=True)
def threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_counts_by_hand():
    assert counts_var.scales(M) == [(1, 0, 1), (4, 1, 5)]
    assert counts_var.unmasked_pairs(M) == 1 * 1 + 4 * 5
    per_token = 2 * (3 * 16 + 16 + 2 * 4 * 16) + 2 * 2 * 4
    per_row = 5 * per_token + 4 * 4 * 21 + 2 * 4 * 24 + 2 * 4 * 8   # attention; shared AdaLN; head
    assert counts_var.var_forward_flops(M, 6, 3) == 6 * per_row + 3 * 5 * 2 * 4 * 8
    assert counts_var.var_call_flops(M, V, 3) == (counts_var.var_forward_flops(M, 6, 3)
                                                  + 3 * counts.vqvae_decode_flops(V, 8))
    # rows 6, H 2, hd 2: scale 0 q 1 row over 1, scale 1 q 4 rows over 5
    b0 = max(2 * (2 * 6 * 2 * 1 * 2 + 2 * 6 * 2 * 1 * 2) / 3.35e12, 4 * 6 * 2 * 1 * 1 * 2 / 989e12)
    b1 = max(2 * (2 * 6 * 2 * 4 * 2 + 2 * 6 * 2 * 5 * 2) / 3.35e12, 4 * 6 * 2 * 4 * 5 * 2 / 989e12)
    assert counts_var.k1_bound_s(M, 6) == pytest.approx(b0 + b1, rel=1e-12)
    want = sum(max((4 * n * 8 + 8 * n) / 3.35e12, 5 * n * 8 / 67e12) for n in (3, 12))
    assert counts_var.k2_bound_s(M, 3) == pytest.approx(want, rel=1e-12)


def test_reference_logits_are_the_ports():
    from controlvar_tpu_torch.models.var import VARModel

    cfg = tiny_cell(WORKLOAD).config
    m = cfg["model"]
    P = WV.var_params(m, cfg["init"], 3, "cpu")
    model = VARModel(WV.model_configs(cfg)[0], device="cpu")
    x_tf = torch.randn(3, model.cfg.seq_len - 1, 32, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([1, 2, 10])
    got = model.forward_train(P, labels, x_tf, train=False, compute_dtype=torch.float32)
    with exact():
        want = rv.forward(P, m, labels, x_tf, Prec())
    assert m["shared_aln"] and m["cos_attn"]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def correct(seconds=1.5):
    result, _, checks = run.run_cell(tiny_cell(WORKLOAD), SEED, seconds, False, "cpu")
    return result["correct"], checks


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    """The line of a window and of a traced run. The traced run checks the
    few images of its 4 calls (126 sampled tokens at this size, where one
    bf16 near-tie at the kept set's edge is 0.8% of draw_outside), so it
    computes in fp32, as the reference does."""
    cell = tiny_cell(WORKLOAD)
    if trace:
        cell.config["compute_dtype"] = "float32"
    result, _, checks = run.run_cell(cell, 2 ** 31 + 12345, 1.5, trace, "cpu")
    device = {"platform": "gpu", "kind": "test", "count": 1, "memory_peak_bytes": 0}
    line = json.loads(json.dumps(run.result_line(result, device, checks)))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert line["correct"] is True and list(line)[-1] == "checks"
    assert set(line["checks"]) == {"logit_gap", "logit_mean", "decode_rms", "draw_outside"}
    want = {m["name"] for m in cell.metrics(trace)}
    if trace:
        assert want == {"launches.var", "mfu.var", "k1_roofline.var", "k2_roofline.var",
                        "adaln_ms.var", "conv_ms.var", "idle_share.var", "loop_idle_ms.var"}
        assert set(line["metrics"]) <= want
    else:
        assert set(line["metrics"]) == want == {"img_s", "setup_s"}


@pytest.mark.parametrize("fault,number", [("drop_top_p", "draw_outside"),
                                           ("altered_token", "logit_mean")])
def test_sampling_fault(fault, number):
    with faults.FAULTS["sample"][fault]():
        ok, checks = correct()
    assert not ok and checks[number]["value"] > checks[number]["limit"], checks


def test_control_separates():
    cell = tiny_cell(WORKLOAD)
    drv = spec.driver(cell.traffic).Driver(cell.config, cell.traffic, 2 ** 32 + 5, "cpu")
    drv.setup()
    drv.window(1.5)
    drv.release()
    program, control = drv.check(), drv.check(control=True)
    assert max(control[k] / max(program[k], 1e-12) for k in program) >= 3.0, (program, control)
