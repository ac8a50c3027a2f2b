"""The port's spans (`controlvar_tpu_torch/utils/tracker.py:span`): off,
one shared null context and no record_function; under torch.profiler on
the CPU, the ranges of a tiny conditional call (cv/call, cv/tokenize,
cv/prologue, a cv/scale/<si> a scale holding cv/blocks, cv/head, cv/draw,
then cv/decode) and of a tiny train step (cv/step holding cv/tokenize,
cv/forward, cv/backward, cv/update and the cv/wait of its host-drawn
masks), each nested as it is called; the same bits with the profiler on
and off; cv/gc around a collection; cv/step in the Chrome trace of a
Trainer's `--profile_dir` window."""
import gc
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from controlvar_tpu_torch.config import ControlVARConfig, OptimConfig, SampleConfig, VQVAEConfig
from controlvar_tpu_torch.data.shards import TokenShardLoader, write_token_shard
from controlvar_tpu_torch.eval.harness import SamplingHarness
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.train.param_groups import named_leaves
from controlvar_tpu_torch.train.trainer import Trainer
from controlvar_tpu_torch.train.train_step import ControlVARTrainStep, init_train_state
from controlvar_tpu_torch.utils import tracker

TINY_VQ = dict(ch=32, patch_nums=(1, 2, 4), vocab_size=64)
TINY = dict(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 4), vocab_size=64,
            cvae=32, num_classes=6, mask_factor=2, multi_cond=True, cond_drop_rate=0.5,
            drop_path_rate=0.2)
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def tiny():
    cfg, vq_cfg = ControlVARConfig(**TINY), VQVAEConfig(**TINY_VQ)
    model, vqvae = ControlVARModel(cfg, device="cpu"), VQVAE(vq_cfg, device="cpu")
    harness = SamplingHarness(model, vqvae, SampleConfig(cfg=(2.0, 2.0, 2.0), top_k=8,
                                                         top_p=0.9),
                              compute_dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(0)
    return dict(cfg=cfg, model=model, vqvae=vqvae, harness=harness,
                params=model.init_params(1), vq_params=vqvae.init_params(0),
                labels=torch.tensor([1, 4]), types=torch.tensor([0, 2]),
                images=torch.rand(B, 64, 64, 3, generator=g) * 2 - 1,
                mask=torch.rand(B, 64, 64, 3, generator=g) * 2 - 1)


def _call(t):
    return t["harness"].control_conditioned(t["params"], t["vq_params"], t["labels"],
                                            t["types"], torch.Generator().manual_seed(3),
                                            t["images"])


def _step(t):
    """A fresh state over a copy of the tiny params after one train step."""
    params = _clone(t["params"])
    optim = OptimConfig(base_lr=1e-3, total_batch_size=512, grad_clip=1.0)
    stepper = ControlVARTrainStep(t["model"], t["vqvae"], optim, max_steps=10, warmup_steps=1,
                                  device="cpu")
    stepper.compute_dtype = stepper.tokenize_dtype = torch.float32
    state = init_train_state(params, optim)
    batch = {"image": t["images"], "mask": t["mask"], "cls": t["labels"], "type": t["types"]}
    _, aux = stepper.step(state, t["vq_params"], batch, torch.Generator().manual_seed(5))
    return state, aux


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def _spans(prof):
    """(name, start us, end us) of every cv/ range the profiler recorded."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith(tracker.SPAN_PREFIX)]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_off_is_one_null_context_and_makes_no_range(tiny, monkeypatch):
    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: made.append(a) or real(*a, **k))
    assert not tracker.profiler_enabled()
    assert tracker.span("call") is tracker.span("scale/3") is tracker._NULL_SPAN
    with tracker.span("blocks") as inside:
        assert inside is None
    _call(tiny)
    _step(tiny)
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracker.profiler_enabled()
        with tracker.span("call"):
            pass
    # a collection inside the window may add its cv/gc range
    assert [a for a in made if a != ("cv/gc",)] == [("cv/call",)]
    assert not tracker.profiler_enabled()


def test_conditional_call_spans(tiny):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call(tiny)
    spans = _spans(prof)
    call, = _named(spans, "cv/call")
    for name in ("cv/tokenize", "cv/prologue", "cv/decode"):
        one, = _named(spans, name)
        assert _inside(one, call)
    tok, pro, dec = (_named(spans, n)[0] for n in ("cv/tokenize", "cv/prologue", "cv/decode"))
    scales = [s for s in spans if s[0].startswith("cv/scale/")]
    assert [s[0] for s in sorted(scales, key=lambda s: s[1])] == [
        f"cv/scale/{si}" for si in range(len(TINY["patch_nums"]))]
    assert tok[2] <= pro[1] and pro[2] <= min(s[1] for s in scales)
    assert max(s[2] for s in scales) <= dec[1]
    for scale in scales:
        assert _inside(scale, call)
        for name in ("cv/blocks", "cv/head", "cv/draw", "cv/canvas"):
            assert len([s for s in _named(spans, name) if _inside(s, scale)]) == 1, name
    for name in ("cv/blocks", "cv/head", "cv/draw", "cv/canvas"):
        assert len(_named(spans, name)) == len(scales)
    assert not _named(spans, "cv/wait")


def test_train_step_spans(tiny):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(tiny)
    spans = _spans(prof)
    step, = _named(spans, "cv/step")
    for name in ("cv/tokenize", "cv/forward", "cv/backward", "cv/update"):
        one, = _named(spans, name)
        assert _inside(one, step), name
    order = [_named(spans, n)[0] for n in ("cv/tokenize", "cv/forward", "cv/backward",
                                           "cv/update")]
    assert all(a[2] <= b[1] for a, b in zip(order, order[1:]))
    waits = _named(spans, "cv/wait")
    # the cond drop's and the drop path's host-drawn masks, both in the forward
    assert len(waits) == 2 and all(_inside(w, order[1]) for w in waits)
    assert not _named(spans, "cv/allreduce")


def test_profiler_on_and_off_give_the_same_bits(tiny):
    off_call = _call(tiny)
    off_state, off_aux = _step(tiny)
    with profile(activities=[ProfilerActivity.CPU]):
        on_call = _call(tiny)
        on_state, on_aux = _step(tiny)
    for a, b in zip(off_call, on_call):
        assert torch.equal(a, b)
    assert torch.equal(off_aux["loss"], on_aux["loss"])
    assert torch.equal(off_aux["grad_norm"], on_aux["grad_norm"])
    on = dict(named_leaves(on_state.params))
    for name, leaf in named_leaves(off_state.params):
        assert torch.equal(leaf, on[name]), name


def test_a_collection_under_the_profiler_is_a_gc_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracker.span("call"):
            gc.collect()
    call, = _named(_spans(prof), "cv/call")
    assert any(_inside(g, call) for g in _named(_spans(prof), "cv/gc"))
    gc.collect()    # the profiler is off: the hook opens nothing
    assert tracker._gc_span._open is None


def test_step_profiler_trace_of_a_trainer_run_holds_its_steps(tmp_path):
    rng = np.random.default_rng(0)
    L = 2 * sum(p * p for p in TINY_VQ["patch_nums"])
    for i in range(4):
        ids = lambda: [rng.integers(0, 64, (B, p * p)) for p in TINY_VQ["patch_nums"]]
        write_token_shard(str(tmp_path / f"tokens_{i:05d}.npz"), ids(), ids(),
                          rng.integers(0, 6, (B,)), rng.integers(0, 4, (B,)),
                          np.ones((B, L), np.float32))
    trainer = Trainer(ControlVARConfig(**TINY), VQVAEConfig(**TINY_VQ),
                      OptimConfig(base_lr=1e-3, total_batch_size=512, epochs=4),
                      TokenShardLoader(str(tmp_path / "tokens_*.npz")),
                      VQVAE(VQVAEConfig(**TINY_VQ), device="cpu").init_params(0),
                      from_tokens=True, profile_dir=str(tmp_path / "prof"),
                      log_fn=lambda m: None, device="cpu")
    trainer.fit(trainer.init_state(seed=1))
    trace, = (tmp_path / "prof").glob("trace_steps_10_13.json")
    names = [e.get("name") for e in json.loads(trace.read_text())["traceEvents"]]
    assert names.count("cv/step") == 3
    assert {"cv/forward", "cv/backward", "cv/update"} <= set(names)
