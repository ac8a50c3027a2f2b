"""The port's utilities (`controlvar_tpu_torch/utils/`) against the JAX
package's: seeding, the smoothed meters and the metric logger (the same
strings), the Tracker's wandb and JSONL paths, its PNG writer (read back
by PIL bit for bit) and the torch.profiler step window."""
import importlib.machinery
import json
import sys
import types

import numpy as np
import pytest
import torch

from controlvar_tpu.utils import misc as jmisc

from controlvar_tpu_torch.utils import misc
from controlvar_tpu_torch.utils.tracker import StepProfiler, Tracker, write_png


def test_seed_everything_seeds_python_numpy_and_torch():
    import random

    misc.seed_everything(7)
    a = (random.random(), np.random.random(), torch.rand(1).item())
    jmisc.seed_everything(7)
    jb = (random.random(), np.random.random())
    misc.seed_everything(7)
    b = (random.random(), np.random.random(), torch.rand(1).item())
    assert a == b and a[:2] == jb


def test_meters_and_logger_match_jax(capsys):
    values = [3.0, 1.5, 2.25, 8.0, 0.5]
    mine, theirs = misc.SmoothedValue(window_size=3), jmisc.SmoothedValue(window_size=3)
    for i, v in enumerate(values):
        mine.update(v, n=i + 1)
        theirs.update(v, n=i + 1)
        assert str(mine) == str(theirs)
        assert (mine.median, mine.avg, mine.global_avg) == (theirs.median, theirs.avg,
                                                           theirs.global_avg)
    ml, jl = misc.MetricLogger(), jmisc.MetricLogger()
    for v in values:
        ml.update(loss=torch.tensor(v), acc=v / 10)
        jl.update(loss=v, acc=v / 10)
    assert str(ml) == str(jl)
    assert list(ml.log_every(range(5), 2, header="ep")) == list(range(5))
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[1] for line in out[:3]] == ["[0/5]", "[2/5]", "[4/5]"]
    assert out[-1].startswith("ep done in")


def test_tracker_falls_back_to_jsonl_without_wandb(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # `import wandb` raises
    tr = Tracker("proj", name="run", out_dir=str(tmp_path))
    tr.log({"loss": torch.tensor(0.5), "note": "x"}, step=3)
    tr.log({"acc": np.float32(0.25)})
    imgs = np.random.default_rng(0).random((2, 5, 7, 3)).astype(np.float32)
    tr.log_images("recon", imgs, step=4, out_dir=str(tmp_path / "media"))
    tr.finish()
    recs = [json.loads(line) for line in (tmp_path / "metrics_run.jsonl").read_text().splitlines()]
    assert [{k: v for k, v in r.items() if k != "t"} for r in recs] == [
        {"step": 3, "loss": 0.5, "note": "x"}, {"acc": 0.25}]
    from PIL import Image

    for i in range(2):
        back = np.asarray(Image.open(tmp_path / "media" / f"recon_4_{i}.png"))
        np.testing.assert_array_equal(back, (np.clip(imgs[i], 0, 1) * 255).astype(np.uint8))


def test_tracker_survives_the_stub_wandb_of_other_tests(tmp_path, monkeypatch):
    """tests/test_train.py leaves a module named wandb without `init` in
    sys.modules: the Tracker falls back to JSONL and its log writes there."""
    stub = types.ModuleType("wandb")
    stub.__spec__ = importlib.machinery.ModuleSpec("wandb", None)
    monkeypatch.setitem(sys.modules, "wandb", stub)
    tr = Tracker("proj", out_dir=str(tmp_path))
    tr.log({"loss": 1.0}, step=0)
    tr.finish()
    assert json.loads((tmp_path / "metrics_proj.jsonl").read_text())["loss"] == 1.0


def test_tracker_uses_wandb_when_it_imports(monkeypatch):
    calls = []
    fake = types.SimpleNamespace(
        init=lambda **kw: calls.append(("init", kw)),
        log=lambda m, step=None: calls.append(("log", m, step)),
        Image=lambda a: ("image", a.shape), finish=lambda: calls.append(("finish",)))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    tr = Tracker("proj", name="n", config={"a": 1})
    tr.log({"x": 1}, step=2)
    tr.log_images("t", np.zeros((1, 2, 2, 3)), step=5)
    tr.finish()
    assert calls == [("init", {"project": "proj", "name": "n", "config": {"a": 1}}),
                     ("log", {"x": 1}, 2), ("log", {"t": [("image", (2, 2, 3))]}, 5),
                     ("finish",)]


@pytest.mark.parametrize("shape", [(1, 1), (3, 17), (64, 5)])
def test_write_png_reads_back_bit_for_bit(tmp_path, shape):
    from PIL import Image

    rgb = np.random.default_rng(1).integers(0, 256, shape + (3,), dtype=np.uint8)
    write_png(str(tmp_path / "a.png"), rgb)
    img = Image.open(tmp_path / "a.png")
    assert img.mode == "RGB" and img.size == (shape[1], shape[0])
    np.testing.assert_array_equal(np.asarray(img), rgb)
    with pytest.raises(ValueError, match="uint8"):
        write_png(str(tmp_path / "b.png"), rgb.astype(np.float32))


def test_step_profiler_traces_its_window(tmp_path):
    prof = StepProfiler(str(tmp_path), start_step=1, num_steps=2)
    for step in range(5):
        prof.step(step)
        torch.ones(8, 8) @ torch.ones(8, 8)
    traces = list(tmp_path.glob("trace_steps_1_3.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]
