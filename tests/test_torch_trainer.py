"""The port's `Trainer` against the JAX package's, fp32 on the CPU, on the
same weights and the same token shards: the loss, grad_norm and lr of every
`fit` step and the params after it, with and without gradient
accumulation; then the port alone: a mid-epoch resume through `stop_after`
equal bit for bit to an uninterrupted run (across an epoch boundary, so the
skipped batches and the recorded epoch count), the `stop_after` horizon,
`set_max_steps`, the from_tokens/bidirectional guard, the bidirectional
coin, LoRA mode, `save_every_steps` and `fit_with_recovery` after an
injected RuntimeError.

Parity runs at the tiny config of tests/test_torch_train_step.py (depth 2,
width 128, patch_nums (1, 2, 4), V 128) with cond drop and drop path off,
since torch's and JAX's random streams differ; both trainers run their
steps in fp32 (the test subclasses, as tests/test_torch_train_step.py
does). B = 8, the JAX trainer's 8 virtual CPU devices. Tolerances as that
file's: the loss to 1e-5 and grad_norm to 1e-4 relative, params after the
steps to 2e-5 absolute at lr 1e-2 (AdamW turns fp32 differences of the
smallest gradients into up to ~3e-6 a step)."""
import dataclasses
import glob
import os
from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlvar_tpu.config import ControlVARConfig as JCfg
from controlvar_tpu.config import OptimConfig as JOptim
from controlvar_tpu.config import VQVAEConfig as JVQCfg
from controlvar_tpu.data.shards import TokenShardLoader as JTokenShardLoader
from controlvar_tpu.models.control_var import ControlVARModel as JModel
from controlvar_tpu.train import trainer as jtrainer
from controlvar_tpu.train.train_step import ControlVARTrainStep as JTrainStep

from controlvar_tpu_torch.ckpt.convert import to_jax_params
from controlvar_tpu_torch.config import ControlVARConfig, OptimConfig, VQVAEConfig
from controlvar_tpu_torch.data.build import Loader
from controlvar_tpu_torch.data.imagenetc import SyntheticControlDataset
from controlvar_tpu_torch.data.shards import TokenShardLoader, write_token_shard
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.train import trainer as ttrainer
from controlvar_tpu_torch.train.lr_schedule import lr_wd_at_step
from controlvar_tpu_torch.train.param_groups import named_leaves
from controlvar_tpu_torch.train.train_step import ControlVARTrainStep

from tests.torch_fixtures import one_torch_thread, vq_to_jax  # noqa: F401

VQ = dict(ch=32, patch_nums=(1, 2, 4), vocab_size=128)
TINY = dict(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 4), vocab_size=128,
            cvae=32, num_classes=8, mask_factor=2, multi_cond=True, cond_drop_rate=0.0)
OPTIM = dict(base_lr=1e-2, total_batch_size=512, grad_clip=1.0)
B, N_SHARDS = 8, 4


@dataclasses.dataclass(frozen=True)
class _JFp32Model(JModel):
    def forward_train(self, *args, **kwargs):
        return super().forward_train(*args, compute_dtype=jnp.float32, **kwargs)


class _JFp32Step(JTrainStep):
    tokenize_dtype = jnp.float32


class _Fp32Step(ControlVARTrainStep):
    tokenize_dtype = torch.float32
    compute_dtype = torch.float32


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Four token shards of B = 8 with random 0/1 ignore masks (their weight
    sums differ from batch to batch)."""
    d = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(0)
    L = 2 * sum(p * p for p in VQ["patch_nums"])
    for i in range(N_SHARDS):
        ids = lambda: [rng.integers(0, 128, (B, p * p)) for p in VQ["patch_nums"]]
        write_token_shard(str(d / f"tokens_{i:05d}.npz"), ids(), ids(),
                          rng.integers(0, 8, (B,)), rng.integers(0, 4, (B,)),
                          (rng.random((B, L)) > 0.3).astype(np.float32))
    return str(d / "tokens_*.npz")


@pytest.fixture(scope="module")
def weights():
    """(port ControlVAR params, port VQVAE params), CPU, from seeds."""
    return (ControlVARModel(ControlVARConfig(**TINY), device="cpu").init_params(1),
            VQVAE(VQVAEConfig(**VQ), device="cpu").init_params(0))


def _clone(tree):
    return {k: _clone(v) for k, v in tree.items()} if isinstance(tree, dict) else (
        [_clone(v) for v in tree] if isinstance(tree, list) else tree.detach().clone())


def _port_trainer(shards, vq_params, **kw):
    optim = OptimConfig(**dict(OPTIM, epochs=kw.pop("epochs", 1),
                               grad_accum=kw.pop("grad_accum", 1)))
    logs = []
    with mock.patch.object(ttrainer, "ControlVARTrainStep", _Fp32Step):
        tr = ttrainer.Trainer(ControlVARConfig(**kw.pop("cfg", TINY)), VQVAEConfig(**VQ), optim,
                              kw.pop("loader", None) or TokenShardLoader(shards),
                              vq_params, from_tokens=kw.pop("from_tokens", True), log_every=1,
                              log_fn=logs.append, device="cpu", **kw)
    return tr, logs


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_fit_matches_the_jax_trainer_step_by_step(shards, weights, grad_accum):
    params, vq_params = weights
    jparams = jax.tree_util.tree_map(jnp.asarray, to_jax_params(params,
                                                                ControlVARConfig(**TINY)))
    jlogs = []
    with mock.patch.object(jtrainer, "ControlVARModel", _JFp32Model), \
            mock.patch.object(jtrainer, "ControlVARTrainStep", _JFp32Step):
        jt = jtrainer.Trainer(JCfg(**TINY), JVQCfg(**VQ),
                              JOptim(**OPTIM, epochs=1, grad_accum=grad_accum),
                              JTokenShardLoader(shards),
                              jax.tree_util.tree_map(jnp.asarray, vq_to_jax(vq_params)),
                              from_tokens=True, log_every=1, log_fn=jlogs.append)
        jstate = jt.fit(jt.init_state(base_params=jparams))
    tr, logs = _port_trainer(shards, vq_params, grad_accum=grad_accum)
    state = tr.fit(tr.init_state(base_params=_clone(params)))
    assert len(logs) == len(jlogs) == N_SHARDS and state.step == int(jstate.step) == N_SHARDS
    for mine, theirs in zip(logs, jlogs):
        assert (mine["step"], mine["epoch"]) == (theirs["step"], theirs["epoch"])
        np.testing.assert_allclose(mine["loss"], theirs["loss"], rtol=1e-5)
        np.testing.assert_allclose(mine["grad_norm"], theirs["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(mine["lr"], theirs["lr"], rtol=1e-6)
        np.testing.assert_allclose(mine["wd"], theirs["wd"], rtol=1e-6)
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jstate.params)[0]}
    got = dict(named_leaves(state.params))
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        np.testing.assert_allclose(leaf.detach().numpy(), want[name], rtol=0, atol=2e-5,
                                   err_msg=name)


def _assert_params_equal(a, b):
    la, lb = dict(named_leaves(a)), dict(named_leaves(b))
    assert sorted(la) == sorted(lb)
    for k in la:
        assert torch.equal(la[k], lb[k]), k


def test_mid_epoch_resume_equals_an_uninterrupted_run(shards, weights, tmp_path):
    """stop_after=3 of 2 epochs x 4 steps, then a fresh Trainer resumes to
    step 6: the resumed epoch-0 step and the two of epoch 1 consume exactly
    the uninterrupted run's batches; the params equal bit for bit."""
    params, vq_params = weights
    straight, _ = _port_trainer(shards, vq_params, epochs=2, stop_after=6,
                                ckpt_dir=str(tmp_path / "a"))
    want = straight.fit(straight.init_state(base_params=_clone(params)))
    first, logs = _port_trainer(shards, vq_params, epochs=2, stop_after=3,
                                ckpt_dir=str(tmp_path / "b"))
    first.fit(first.init_state(base_params=_clone(params)))
    assert [m["step"] for m in logs] == [0, 1, 2]
    assert first.io.restore_raw()[1] == {"epoch": 0}  # stopped mid-epoch 0
    second, logs = _port_trainer(shards, vq_params, epochs=2, stop_after=6,
                                 ckpt_dir=str(tmp_path / "b"))
    state, epoch = second.maybe_resume(second.init_state(base_params=_clone(params)))
    assert (state.step, epoch) == (3, 0)
    got = second.fit(state, epoch)
    assert [(m["step"], m["epoch"]) for m in logs] == [(3, 0), (4, 1), (5, 1)]
    assert got.step == want.step == 6
    _assert_params_equal(got.params, want.params)
    # the optimizers too: the resumed Adam moments continue the same run
    sa, sb = got.optimizer.state_dict()["state"], want.optimizer.state_dict()["state"]
    assert all(torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"]) for i in sa)


def test_stop_after_keeps_the_lr_horizon_and_set_max_steps_moves_it(shards, weights):
    params, vq_params = weights
    tr, logs = _port_trainer(shards, vq_params, epochs=3, stop_after=2)
    assert tr.max_steps == tr.stepper.max_steps == 3 * N_SHARDS
    state = tr.fit(tr.init_state(base_params=_clone(params)))
    assert state.step == 2 and len(logs) == 2
    optim = tr.optim
    for m in logs:
        lr, wd = lr_wd_at_step(optim.schedule, m["step"], optim.lr, optim.weight_decay,
                               optim.wd_end, 1, 3 * N_SHARDS, wp0=optim.warmup_init_frac)
        assert (m["lr"], m["wd"]) == (lr, wd)
    tr, logs = _port_trainer(shards, vq_params, epochs=3)
    tr.set_max_steps(5)
    assert tr.max_steps == tr.stepper.max_steps == 5 and tr.stepper.warmup_steps == 1
    state = tr.fit(tr.init_state(base_params=_clone(params)))
    assert state.step == 5 and [m["epoch"] for m in logs] == [0, 0, 0, 0, 1]
    lr4 = lr_wd_at_step(optim.schedule, 4, optim.lr, optim.weight_decay, optim.wd_end, 1, 5,
                        wp0=optim.warmup_init_frac)[0]
    assert logs[-1]["lr"] == lr4


def test_from_tokens_refuses_bidirectional(shards, weights):
    with pytest.raises(ValueError, match="bidirectional"):
        _port_trainer(shards, weights[1], cfg=dict(TINY, bidirectional=True))


def test_bidirectional_coin_restarts_at_each_fit(weights):
    """The pixel path of a bidirectional config: each step's stream order is
    the JAX trainer's coin, np.random.default_rng(1234) drawn once a step,
    restarted by every fit call (as the JAX trainer does); mask_first_sampler
    replaces it."""
    cfg = dict(TINY, bidirectional=True)
    vq_params = weights[1]
    ds = SyntheticControlDataset(image_size=64, num_classes=8, patch_nums=(1, 2, 4), length=8)
    tr, logs = _port_trainer(None, vq_params, cfg=cfg, from_tokens=False, epochs=2,
                             loader=Loader(ds, batch_size=2, num_workers=1))
    orders = []
    real = tr.stepper.step

    def spy(state, vq, batch, gen, mask_first, **kw):
        orders.append(mask_first)
        assert "ignore_mask_" in batch and batch["image"].shape == (2, 64, 64, 3)
        return real(state, vq, batch, gen, mask_first, **kw)

    tr.stepper.step = spy
    rng = np.random.default_rng(1234)
    coin = [not rng.random() < 0.5 for _ in range(4)]
    state = tr.init_state(seed=1)
    tr.stop_after = 4
    tr.fit(state)
    assert orders == coin and len(set(orders)) == 2
    tr.stop_after = 6
    tr.fit(state)  # resumes at step 4; the coin restarts
    assert orders[4:] == coin[:2]
    orders.clear()
    tr.stop_after = None
    state.step = 0
    tr.fit(state, mask_first_sampler=lambda i: i % 2 == 1)
    assert orders == [True, False] * 4


def test_lora_mode_trains_only_the_factors(shards, weights):
    """lora_rank > 0: the state holds the (A, B) factors alone, the base is
    left as it was, and the steps equal LoRAControlVARTrainStep's called by
    hand with the trainer's per-step generators."""
    from controlvar_tpu_torch.ckpt.lora import LoRAConfig
    from controlvar_tpu_torch.device import generator_for
    from controlvar_tpu_torch.train.train_step import LoRAControlVARTrainStep

    params, vq_params = weights
    base = _clone(params)
    tr, logs = _port_trainer(shards, vq_params, lora_rank=4, stop_after=2)
    state = tr.init_state(seed=5, base_params=base)
    names = dict(named_leaves(params))
    assert set(state.params) == {"/".join(t) for t in LoRAConfig().targets
                                 if "/".join(t) in names} != set()
    state = tr.fit(state)
    assert state.step == 2 and all(np.isfinite(m["loss"]) for m in logs)
    _assert_params_equal(base, params)
    assert all(float(f["B"].detach().abs().max()) > 0 for f in state.params.values())
    # by hand
    stepper = LoRAControlVARTrainStep(tr.stepper, LoRAConfig(rank=4))
    hand = stepper.init_lora_state(generator_for(6), _clone(params), tr.optim)
    loader = TokenShardLoader(shards)
    for i, batch in zip(range(2), loader.epoch(0)):
        stepper.step(hand, params, vq_params, {k: batch[k] for k in (
            "ctrl_ids", "img_ids", "cls", "type", "ignore_mask")}, generator_for(i),
            from_tokens=True)
    _assert_params_equal(state.params, hand.params)


class _FailOnce:
    """A loader that raises RuntimeError once, at (epoch, batch)."""

    def __init__(self, inner, epoch, batch):
        self.inner, self.at, self.armed = inner, (epoch, batch), True

    def steps_per_epoch(self):
        return self.inner.steps_per_epoch()

    def epoch(self, epoch, skip_batches=0):
        for b, batch in enumerate(self.inner.epoch(epoch, skip_batches), start=skip_batches):
            if self.armed and (epoch, b) == self.at:
                self.armed = False
                raise RuntimeError("injected device failure")
            yield batch


def test_fit_with_recovery_restores_and_equals_an_uninterrupted_run(shards, weights, tmp_path,
                                                                    capsys):
    params, vq_params = weights
    straight, _ = _port_trainer(shards, vq_params, epochs=2)
    want = straight.fit(straight.init_state(base_params=_clone(params)))
    tr, logs = _port_trainer(shards, vq_params, epochs=2, save_every_steps=2,
                             ckpt_dir=str(tmp_path), loader=_FailOnce(TokenShardLoader(shards),
                                                                      1, 2))
    got = tr.fit_with_recovery(tr.init_state(base_params=_clone(params)))
    assert "[recovery] RuntimeError: injected device failure" in capsys.readouterr().out
    # steps 0-5 ran, the failure at step 6 restored step 4's checkpoint
    # (saved after step 4, holding 5 steps), which replayed step 5
    assert [m["step"] for m in logs] == [0, 1, 2, 3, 4, 5, 5, 6, 7]
    assert got.step == want.step == 8
    _assert_params_equal(got.params, want.params)
    steps = sorted(int(os.path.basename(p)[:-3]) for p in glob.glob(str(tmp_path / "*.pt")))
    assert steps == [4, 6, 8]  # max_to_keep 3 of saves at 2, 4, (4), 6, 8
