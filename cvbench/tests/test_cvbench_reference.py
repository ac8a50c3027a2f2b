"""The plain reference (`cvbench/reference/`) against the port at depth 2 on
seeded weights (`cvbench/weights.py`), in fp32 on the CPU: logits, the
VQVAE, and training steps with drop path and the class drop."""
import copy

import pytest
import torch

from cvbench import judge
from cvbench import weights as W
from cvbench.reference import controlvar as cv
from cvbench.reference import vqvae as vq
from cvbench.reference.prec import Prec, exact
from cvbench.tests.tiny import tiny_cell


@pytest.fixture(scope="module", autouse=True)
def threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("workload", ["d16_cond_b16", "d30_train_b8"])
def test_logits(workload):
    from controlvar_tpu_torch.models.control_var import ControlVARModel

    cfg = tiny_cell(workload).config
    m = cfg["model"]
    P = W.controlvar_params(m, cfg["init"], 3, "cpu")
    model = ControlVARModel(W.model_configs(cfg)[0], device="cpu")
    g = torch.Generator().manual_seed(0)
    x_tf = torch.randn(3, model.cfg.seq_len - 2, 32, generator=g)
    labels, types = torch.tensor([1, 2, 10]), torch.tensor([0, 3, 4])
    got = model.forward_train(P, labels, x_tf, cond_type=types, train=False,
                              compute_dtype=torch.float32)
    with exact():
        want = cv.forward(P, m, labels, types, x_tf, Prec())
    assert m["cos_attn"] == (workload == "d30_train_b8")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_vqvae():
    from controlvar_tpu_torch.models.vqvae import VQVAE

    cfg = tiny_cell("d16_cond_b16").config
    v = cfg["vqvae"]
    p = W.vqvae_params(v, 4, "cpu")
    port = VQVAE(W.model_configs(cfg)[1], device="cpu")
    img = W.pixel_images(2, 64, 1, "x", "cpu")
    with exact():
        f = vq.encode(p, img, v, Prec())
        torch.testing.assert_close(port.encode_f(p, img), f, rtol=0, atol=1e-5)
        ids = port.img_to_ids(p, img)
        assert vq.code_gaps(p, f, ids, v) == 0.0
        assert [torch.equal(a, b) for a, b in
                zip(vq.nearest_ids(p, f, v), ids)] == [True] * 3
        for a, b in zip(vq.teacher_inputs(p, ids, v), port.ids_to_var_input(p, ids)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
        f_hat = vq.fhat_from_ids(p, ids, v)
        torch.testing.assert_close(f_hat, port.quantizer.ids_to_fhat(p["quantize"], ids),
                                   rtol=0, atol=1e-5)
        torch.testing.assert_close(vq.decode(p, f_hat, v, Prec()), port.fhat_to_img(p, f_hat),
                                   rtol=0, atol=1e-4)


def test_train_steps():
    """Two fp32 steps of the port's ControlVARTrainStep against the
    reference's: losses, each leaf's clipped first gradient and each leaf's
    change, the same class drops and drop path drawn from one seed."""
    from cvbench.drivers.train_step import Driver

    cell = tiny_cell("d30_train_b8")
    cfg = copy.deepcopy(cell.config)
    cfg["compute_dtype"] = "float32"
    cfg["model"]["cond_drop_rate"] = 0.5      # some rows drop their class and type
    traffic = dict(cell.traffic, checked_steps=2)
    drv = Driver(cfg, traffic, 11, "cpu")
    drv.setup()
    want = judge.reference_train(
        cfg, 11, drv.batches[:2], drv._generator(), "cpu", Prec())
    got = drv.readings
    assert got["losses"] == pytest.approx(want["losses"], rel=1e-5)
    for name, g in want["grad"].items():
        assert got["grad"][name] == pytest.approx(g, rel=1e-4, abs=1e-9), name
    for name, c in want["change"].items():
        assert got["change"][name] == pytest.approx(c, rel=1e-3, abs=1e-9), name


def test_drop_draws_follow_the_program():
    """The reference's draws of a step are the program's: the class and cond
    type drop (`_drop_cond`), then drop path (`_drop_path`)."""
    from controlvar_tpu_torch.models import transformer as tfm
    from controlvar_tpu_torch.models.control_var import ControlVARModel

    cfg = tiny_cell("d30_train_b8").config
    m = dict(cfg["model"], cond_drop_rate=0.5)
    mc = W.model_configs(dict(cfg, model=m))[0]
    model = ControlVARModel(mc, device="cpu")
    ga, gb = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    labels, types = torch.arange(6), torch.arange(6) % 4
    lab, typ = model._drop_cond(labels, types, ga)
    import numpy as np
    keep = tfm._drop_path(ga, np.linspace(0.0, mc.drop_path_rate, mc.depth, dtype=np.float32),
                          6, torch.float32)
    drop, keep_ref = cv.drop_draws(gb, m, 6)
    assert torch.equal(lab, torch.where(drop[0], m["num_classes"], labels))
    assert torch.equal(typ, torch.where(drop[1], cv.COND_UNCOND, types))
    torch.testing.assert_close(keep, keep_ref)



@pytest.mark.parametrize("top_k,top_p", [(900, 0.96), (40, 0.5), (0, 0.9), (1, 0.0)])
def test_kept_set(top_k, top_p):
    """The reference's kept set is the port's bisection filter's, and an id
    is kept exactly when its mass above is under top_p (or, without top_p,
    when it lies in the top k)."""
    from controlvar_tpu_torch.ops.sample_kernel import kept_mask_plain

    from cvbench.reference import sampling as rs

    V = 1024 if top_k < 1024 else 4096
    logits = torch.randn(8, V, generator=torch.Generator().manual_seed(5)) * 3
    kept = rs.kept_mask(logits, top_k, top_p)
    assert torch.equal(kept, kept_mask_plain(logits, top_k, top_p))
    rows = logits.repeat_interleave(V, 0)
    above = rs.mass_above(rows, torch.arange(V).repeat(8), top_k).reshape(8, V)
    assert torch.equal(kept, above < (top_p if top_p > 0 else 1.0))
