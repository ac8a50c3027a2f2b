"""The port's tensor parallelism (`parallel/mesh.py`, `parallel/tensor.py`)
against the JAX package's mesh runs, on the CPU.

Config: ControlVAR depth 2, C=256, 4 heads of 64, patch_nums (1, 2, 4),
V=64, multi_cond, fp32, JAX init carried over by `from_jax_params` (the
tokenizer's is the port's, carried the other way), every
bias random (zero at init, it would hide a bias added on each rank before
a row-parallel sum) and the AdaLN gates raised (attention by 10, FFN by 1)
so that every layer's attention moves the draws. Two gloo worlds run together, one subprocess a rank
(tests/torch_tp_worker.py): model=2 (two ranks) and data=2 x model=2 (four
ranks). They are held against:
  - JAX `sample_joint_cfg` on its 8-device CPU mesh at data=2, model=4, as
    tests/test_parallel.py runs it (its per-scale ids from the same call on
    one device, which that test holds equal), and the JAX
    `StepwiseCondSampler`: greedy (top_k=1) ids equal bit for bit, f_hats
    within 1e-4 absolute (fp32 reassociation, as tests/test_torch_joint.py);
  - one JAX `ControlVARTrainStep` step on its mesh at data=4, model=2, as
    tests/test_train.py runs it (fp32 tokenizer and residual stream, lr
    1e-2, no random draws): params within 1e-5 absolute, loss within 1e-5
    and grad_norm within 1e-4 relative, the port-to-JAX tolerances of
    tests/test_torch_train_step.py;
  - the same step of the port on one process: params within 2e-6 absolute,
    loss within 1e-6 and grad_norm within 1e-5 relative, the tolerances of
    tests/test_torch_parallel.py (the row-parallel sums and the gradient
    sums run in another order, ~1e-7 relative, and AdamW's first step
    moves each param by about lr);
and the ranks of a model group must hold the same draws (top-k 8 from
generators seeded apart: the broadcast of model rank 0's ids) and the same
whole leaves bit for bit. A step with cond drop and drop path at 0.5 on two
ranks equals the one-process step with the same generator (the ranks draw
the same masks). `Trainer(model_axis=2)` checkpoints hold the whole state:
a single-device Trainer resumes one and takes the next step as the
tensor-parallel run did, and the reverse."""
import dataclasses
import os
import shutil
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import controlvar_tpu.models.control_var as j_control_var
import controlvar_tpu.eval.stepwise as j_stepwise
from controlvar_tpu.config import ControlVARConfig as JCfg
from controlvar_tpu.config import OptimConfig as JOptim
from controlvar_tpu.config import VQVAEConfig as JVQCfg
from controlvar_tpu.models.control_var import ControlVARModel as JModel
from controlvar_tpu.models.vqvae import VQVAE as JVQVAE
from controlvar_tpu.parallel.mesh import make_mesh as j_make_mesh
from controlvar_tpu.parallel.mesh import param_shardings as j_param_shardings
from controlvar_tpu.train.train_step import ControlVARTrainStep as JTrainStep
from controlvar_tpu.train.train_step import init_train_state as j_init_train_state

from controlvar_tpu_torch.ckpt.convert import from_jax_params
from controlvar_tpu_torch.ckpt.orbax_io import CheckpointIO
from controlvar_tpu_torch.config import (ControlVARConfig, MeshConfig, OptimConfig,
                                         VQVAEConfig, control_var_config_from_depth)
from controlvar_tpu_torch.data.build import Loader
from controlvar_tpu_torch.data.imagenetc import SyntheticControlDataset
from controlvar_tpu_torch.eval.stepwise import StepwiseCondSampler, StepwiseJointSampler
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.var import VARModel
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.parallel import mesh as tmesh
from controlvar_tpu_torch.parallel.tensor import (cut, leaf_split, merge_shards,
                                                  shard_opt_state, shard_params)
from controlvar_tpu_torch.train import trainer as trainer_mod
from controlvar_tpu_torch.train.param_groups import named_leaves
from controlvar_tpu_torch.train.train_step import ControlVARTrainStep, init_train_state
from tests.torch_fixtures import one_torch_thread, raise_gates, vq_to_jax  # noqa: F401
from tests.torch_world import World

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_tp_worker.py")
VQ = dict(ch=32, patch_nums=(1, 2, 4), vocab_size=64)
TINY = dict(depth=2, embed_dim=256, num_heads=4, patch_nums=(1, 2, 4), vocab_size=64,
            cvae=32, num_classes=8, mask_factor=2, multi_cond=True, cond_drop_rate=0.0)
B_SAMPLE, B_TRAIN = 2, 8
WORLDS = ((2, 2), (4, 2))  # (processes, model axis)


class _JFp32Model(JModel):
    def forward_train(self, *args, **kwargs):
        return super().forward_train(*args, compute_dtype=jnp.float32, **kwargs)


class _JFp32Step(JTrainStep):
    tokenize_dtype = jnp.float32


class _Fp32Step(ControlVARTrainStep):
    tokenize_dtype = torch.float32
    compute_dtype = torch.float32


def _inputs():
    """JAX params and their numpy trees, the batches and the forced ids,
    from seeds. The biases, zero at init, get random values (a bias added
    on every rank before the row-parallel sum, model times over, would not
    show otherwise), then the gates are raised. The tokenizer is the port's
    init in the JAX layout (the JAX one's eager init takes ~10 s on the
    CPU)."""
    jp = jax.tree_util.tree_map(np.array,
                                jax.jit(JModel(JCfg(**TINY)).init_params)(jax.random.key(1)))
    rng = np.random.default_rng(0)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        if str(getattr(path[-1], "key", "")).endswith("bias"):
            leaf += rng.normal(0.0, 0.02, leaf.shape).astype(leaf.dtype)
    jp = raise_gates(jp)
    jvp = vq_to_jax(VQVAE(VQVAEConfig(**VQ), device="cpu").init_params(0))
    img = lambda: (rng.random((B_TRAIN, 64, 64, 3)) * 2 - 1).astype(np.float32)
    batch = dict(image=img(), mask=img(), cls=rng.integers(0, 8, (B_TRAIN,)),
                 type=rng.integers(0, 4, (B_TRAIN,)))
    forced = [rng.integers(0, VQ["vocab_size"], (B_SAMPLE, p * p)) for p in VQ["patch_nums"]]
    return jp, jvp, batch, forced, np.array([1, 5]), np.array([0, 2])


def _trainer(cfg, ckpt_dir, stop_after, vq_params):
    """A single-device fp32 Trainer run to step `stop_after`, resuming the
    latest checkpoint in ckpt_dir (the workers run the same loader)."""
    ds = SyntheticControlDataset(image_size=64, num_classes=8, patch_nums=cfg.patch_nums,
                                 length=8)
    loader = Loader(ds, batch_size=2, num_workers=1)
    saved, trainer_mod.ControlVARTrainStep = trainer_mod.ControlVARTrainStep, _Fp32Step
    try:
        tr = trainer_mod.Trainer(cfg, VQVAEConfig(**VQ),
                                 OptimConfig(base_lr=1e-2, total_batch_size=512, epochs=1),
                                 loader, vq_params, ckpt_dir=ckpt_dir, stop_after=stop_after,
                                 log_every=1, log_fn=lambda m: None, device="cpu")
        state, epoch = tr.maybe_resume(tr.init_state(seed=1))
        return tr.fit(state, epoch)
    finally:
        trainer_mod.ControlVARTrainStep = saved


def _jax_runs(jp, jvp, batch, forced, labels, ct):
    """The JAX references: sample_joint_cfg on the 2x4 mesh (f_hats) and on
    one device (ids), StepwiseCondSampler, the train step on the 4x2 mesh."""
    devices = jax.devices()
    jm, jv = JModel(JCfg(**TINY)), JVQVAE(JVQCfg(**VQ))
    out = {}
    sample = jax.jit(lambda p, vp, l, c, k: jm.sample_joint_cfg(
        p, jv, vp, l, c, k, cfg_scale=2.0, top_k=1, top_p=0.0, compute_dtype=jnp.float32,
        decode_img=False))
    args = (jnp.asarray(labels, jnp.int32), jnp.asarray(ct, jnp.int32), jax.random.key(7))
    mesh = j_make_mesh(data=2, model=4, devices=devices)
    repl = NamedSharding(mesh, P())
    with mesh:
        out["joint_fh_mesh"] = [np.asarray(t) for t in sample(
            jax.device_put(jp, j_param_shardings(mesh, jp)),
            jax.device_put(jvp, jax.tree_util.tree_map(lambda _: repl, jvp)), *args)]
    ids = []
    orig = j_control_var.sample_top_k_top_p

    def spy(*a, **kw):
        r = orig(*a, **kw)
        jax.debug.callback(lambda x: ids.append(np.asarray(x)), r, ordered=True)
        return r

    j_control_var.sample_top_k_top_p = spy
    try:
        out["joint_fh"] = [np.asarray(t) for t in jax.jit(
            lambda p, vp, l, c, k: jm.sample_joint_cfg(
                p, jv, vp, l, c, k, cfg_scale=2.0, top_k=1, top_p=0.0,
                compute_dtype=jnp.float32, decode_img=False))(jp, jvp, *args)]
        jax.effects_barrier()
    finally:
        j_control_var.sample_top_k_top_p = orig
    out["joint_ids"] = list(ids)
    ids.clear()
    orig_sw = j_stepwise.sample_top_k_top_p
    j_stepwise.sample_top_k_top_p = spy
    try:
        js = j_stepwise.StepwiseCondSampler(jm, jv, cfg_scales=(2.0, 2.0, 2.0), top_k=1,
                                            top_p=0.0)
        js.compute_dtype = jnp.float32
        out["cond_fh"] = [np.asarray(t) for t in js(
            jp, jvp, args[0], args[1], jax.random.key(8),
            [jnp.asarray(f, jnp.int32) for f in forced], decode_img=False)]
        jax.effects_barrier()
    finally:
        j_stepwise.sample_top_k_top_p = orig_sw
    out["cond_ids"] = list(ids)
    # the train step, sharded as tests/test_train.py shards it
    optim = JOptim(base_lr=1e-2, total_batch_size=512, grad_clip=1.0)
    stepper = _JFp32Step(_JFp32Model(JCfg(**TINY)), jv, optim, max_steps=100, warmup_steps=1)
    state, tx = j_init_train_state(jp, optim)
    mesh = j_make_mesh(data=4, model=2, devices=devices)
    repl, batch_sh = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    state = state._replace(params=jax.device_put(state.params,
                                                 j_param_shardings(mesh, state.params)))
    jb = {k: jax.device_put(jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i" else v),
                            batch_sh) for k, v in batch.items()}
    with mesh:
        state, aux = jax.jit(lambda s, vp, b, k: stepper.step(tx, s, vp, b, k))(
            state, jax.device_put(jvp, jax.tree_util.tree_map(lambda _: repl, jvp)), jb,
            jax.random.key(5))
        assert state.params["blocks"]["qkv_kernel"].sharding.spec == P(None, None, "model")
    out["step_params"] = jax.tree_util.tree_map(np.asarray, state.params)
    out["step_aux"] = (float(aux["loss"]), float(aux["grad_norm"]))
    return out


def _one_process_step(tp, tvp, batch, cfg, seed=None):
    optim = OptimConfig(base_lr=1e-2, total_batch_size=512, grad_clip=1.0)
    step = _Fp32Step(ControlVARModel(cfg, device="cpu"), VQVAE(VQVAEConfig(**VQ), device="cpu"),
                     optim, max_steps=100, warmup_steps=1, device="cpu")
    state = init_train_state(_clone(tp), optim)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    state, aux = step.step(state, tvp, batch, gen)
    return (dict((k, v.detach()) for k, v in named_leaves(state.params)), float(aux["loss"]),
            float(aux["grad_norm"]), {k: v.grad for k, v in named_leaves(state.params)})


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' per-rank results beside the JAX and one-process ones."""
    d = tmp_path_factory.mktemp("tp")
    jp, jvp, batch, forced, labels, ct = _inputs()
    cfg, vq_cfg = ControlVARConfig(**TINY), VQVAEConfig(**VQ)
    tp, tvp = from_jax_params(jp, cfg, device="cpu"), from_jax_params(jvp, vq_cfg, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    torch.save(dict(cfg=TINY, vq_cfg=VQ, params=tp, vq_params=tvp, batch=tbatch,
                    forced=[torch.from_numpy(f) for f in forced],
                    labels=torch.from_numpy(labels), ct=torch.from_numpy(ct)), d / "inputs.pt")
    # the single-device checkpoint at step 1 that a tensor-parallel Trainer resumes
    _trainer(cfg, str(d / "one_ckpt"), 1, tvp)
    os.makedirs(d / "one_to_tp")
    shutil.copy(d / "one_ckpt" / "1.pt", d / "one_to_tp" / "1.pt")
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "DIST_BACKEND")}
    env["OMP_NUM_THREADS"] = "1"
    worlds = []
    for world, model in WORLDS:
        wd = d / f"world{world}"

        def prepare(wd=wd):
            shutil.rmtree(wd, ignore_errors=True)
            os.makedirs(wd)
            os.symlink(d / "inputs.pt", wd / "inputs.pt")
            shutil.copytree(d / "one_to_tp", wd / "one_to_tp")

        # the second port, of world == model, is the CLI run's group
        worlds.append(World(lambda ports, world=world, model=model, wd=wd: [
            [sys.executable, WORKER, str(r), str(world), str(model), *ports[:1], str(wd),
             *ports[1:]] for r in range(world)], n_ports=2 if world == model else 1, env=env,
            prepare=prepare))
    try:
        ref = _jax_runs(jp, jvp, batch, forced, labels, ct)
        ref["one_step"] = _one_process_step(tp, tvp, tbatch, cfg)
        ref["one_drop_step"] = _one_process_step(
            tp, tvp, tbatch, ControlVARConfig(**dict(TINY, cond_drop_rate=0.5,
                                                     drop_path_rate=0.5)), seed=9)
        ref["one_resumed"] = _trainer(cfg, str(d / "one_ckpt"), 2, tvp)
        logs = [log for w in worlds for log in w.wait(240)]
    finally:
        for w in worlds:
            w.kill()
    # the single-device Trainer resumes the tensor-parallel checkpoint of step 1
    os.makedirs(d / "tp_to_one")
    shutil.copy(d / "world2" / "tp_ckpt" / "1.pt", d / "tp_to_one" / "1.pt")
    ref["tp_to_one"] = _trainer(cfg, str(d / "tp_to_one"), 2, tvp)
    ranks = {world: [torch.load(d / f"world{world}" / f"rank{r}_of{world}.pt",
                                weights_only=True) for r in range(world)]
             for world, _ in WORLDS}
    return dict(ref=ref, ranks=ranks, dir=d, cfg=cfg, logs=logs)


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in path): leaf
            for path, leaf in flat}


@pytest.mark.parametrize("world", [w for w, _ in WORLDS])
def test_layout_and_shards(runs, world):
    """Each rank's place on the mesh and its heads; gather_params of the
    shards is the whole tree bit for bit on every rank."""
    model = dict(WORLDS)[world]
    whole = torch.load(runs["dir"] / "inputs.pt", weights_only=True)["params"]
    whole = dict(named_leaves(whole))
    for r, out in enumerate(runs["ranks"][world]):
        assert out["mesh"] == (world // model, model, r // model, r % model)
        assert out["heads"] == TINY["num_heads"] // model
        assert sorted(out["round_trip"]) == sorted(whole)
        for name, t in whole.items():
            assert torch.equal(out["round_trip"][name], t), name


@pytest.mark.parametrize("world", [w for w, _ in WORLDS])
@pytest.mark.parametrize("kind", ["joint", "cond"])
def test_greedy_ids_equal_jax_bit_for_bit(runs, world, kind):
    ref = runs["ref"]
    assert len(ref[f"{kind}_ids"]) == len(VQ["patch_nums"])
    for out in runs["ranks"][world]:
        got = out[f"{kind}_ids"]
        assert len(got) == len(ref[f"{kind}_ids"])
        for si, (a, b) in enumerate(zip(got, ref[f"{kind}_ids"])):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f"{kind} scale {si}")
        want = ref["joint_fh_mesh"] if kind == "joint" else ref["cond_fh"]
        for a, b in zip(out[f"{kind}_fh"], want):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=0)
    if kind == "joint":  # JAX's mesh run is its one-device run
        for a, b in zip(ref["joint_fh_mesh"], ref["joint_fh"]):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


@pytest.mark.parametrize("world", [w for w, _ in WORLDS])
def test_sample_cond_cfg_matches_the_jax_sampler(runs, world):
    """The model-level teacher-forced sampler, sharded: the JAX
    StepwiseCondSampler's f_hats on the same forced ids, greedy."""
    for out in runs["ranks"][world]:
        for a, b in zip(out["cond_model_fh"], runs["ref"]["cond_fh"]):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=0)


def test_ranks_hold_model_rank_0s_draws(runs):
    a, b = (out["random_ids"] for out in runs["ranks"][2])
    assert len(a) == len(VQ["patch_nums"])
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert any(int(x.max()) > 0 for x in a)  # top-k 8 draws, not greedy


@pytest.mark.parametrize("world", [w for w, _ in WORLDS])
def test_step_matches_jax_mesh_and_one_process(runs, world):
    ref = runs["ref"]
    want_jax = _jax_leaves(ref["step_params"])
    want_one, loss_one, norm_one, _ = ref["one_step"]
    for out in runs["ranks"][world]:
        params, _, loss, norm, _ = out["step"]
        assert sorted(params) == sorted(want_jax) == sorted(want_one)
        for name in params:
            np.testing.assert_allclose(params[name].numpy(), want_jax[name], atol=1e-5, rtol=0,
                                       err_msg=name)
            np.testing.assert_allclose(params[name].numpy(), want_one[name].numpy(), atol=2e-6,
                                       rtol=0, err_msg=name)
        np.testing.assert_allclose(loss, ref["step_aux"][0], rtol=1e-5)
        np.testing.assert_allclose(norm, ref["step_aux"][1], rtol=1e-4)
        np.testing.assert_allclose(loss, loss_one, rtol=1e-6)
        np.testing.assert_allclose(norm, norm_one, rtol=1e-5)


@pytest.mark.parametrize("world", [w for w, _ in WORLDS])
def test_ranks_hold_equal_whole_leaves_and_gathered_params(runs, world):
    outs = runs["ranks"][world]
    keys = ["step"] + (["drop_step"] if world == 2 else [])
    for key in keys:
        first_params, first_whole = outs[0][key][:2]
        assert len(first_whole) > 5 and "pos_1LC" in first_whole
        for out in outs[1:]:
            params, whole = out[key][:2]
            for name, t in whole.items():
                assert torch.equal(t, first_whole[name]), (key, name)
            for name, t in params.items():
                assert torch.equal(t, first_params[name]), (key, name)


def test_drop_masks_equal_the_one_process_step(runs):
    """Cond drop and drop path at 0.5 on two ranks: the step of one process
    with the same generator, at the plain step's tolerances; the clipped
    gradients within 1e-5 of each leaf's largest (the clip factor carries
    grad_norm's relative error)."""
    want, loss_one, norm_one, want_g = runs["ref"]["one_drop_step"]
    loss_plain = runs["ranks"][2][0]["step"][2]
    params, _, loss, norm, grads = runs["ranks"][2][0]["drop_step"]
    assert abs(loss - loss_plain) > 1e-3  # the masks moved the loss
    assert sorted(grads) == sorted(want_g) == sorted(params)
    for name, g in grads.items():
        w = want_g[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(params[name].numpy(), want[name].numpy(), atol=2e-6,
                                   rtol=0, err_msg=name)
    np.testing.assert_allclose(loss, loss_one, rtol=1e-6)
    np.testing.assert_allclose(norm, norm_one, rtol=1e-5)


@pytest.mark.parametrize("case", ["tp_to_one", "one_to_tp"])
def test_checkpoints_cross_the_model_axis(runs, case):
    """A tensor-parallel step-1 checkpoint resumed by a single-device
    Trainer takes the step the tensor-parallel run took, and the reverse;
    the checkpoints hold whole trees."""
    d = runs["dir"]
    if case == "tp_to_one":
        got = runs["ref"]["tp_to_one"]
        want_raw, _ = CheckpointIO(str(d / "world2" / "tp_ckpt")).restore_raw(2)
        assert [o["trainer_step"] for o in runs["ranks"][2]] == [2, 2]
    else:
        got = runs["ref"]["one_resumed"]
        want_raw, _ = CheckpointIO(str(d / "world2" / "one_to_tp")).restore_raw(2)
    assert got.step == want_raw["step"] == 2
    want = dict(named_leaves(want_raw["params"]))
    got_p = {k: v.detach().numpy() for k, v in named_leaves(got.params)}
    assert sorted(got_p) == sorted(want)
    for name in want:
        assert want[name].shape == got_p[name].shape
        np.testing.assert_allclose(got_p[name], want[name], atol=2e-6, rtol=0, err_msg=name)
    # the saved AdamW moments are whole too
    moments = want_raw["optimizer"]["state"]
    assert all(m["exp_avg"].shape == m["exp_avg_sq"].shape for m in moments.values())
    assert sum(m["exp_avg"].size for m in moments.values()) == sum(v.size
                                                                   for v in want.values())


def test_cli_train_with_a_model_axis(runs):
    """`cli.main train --model_axis 2` on the two ranks: the primary logs
    both steps and the checkpoint holds the whole depth-2 model."""
    raw, _ = CheckpointIO(str(runs["dir"] / "world2" / "cli_ckpt")).restore_raw()
    assert raw["step"] == 2
    assert raw["params"]["blocks"]["qkv_kernel"].shape == (2, 128, 384)
    assert raw["params"]["head"]["kernel"].shape == (128, 4096)
    steps = [log.count("loss=") for log in runs["logs"][:2]]
    assert steps == [2, 0]


# ---- in one process: the cuts, the layout rules, the guards -----------------

def _random_tree(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = ControlVARModel(cfg, device="cpu").init_params(seed)
    return {k: (_random_tree_like(v, g) if isinstance(v, dict) else torch.randn(
        v.shape, generator=g)) for k, v in p.items()}


def _random_tree_like(tree, g):
    return {k: (_random_tree_like(v, g) if isinstance(v, dict) else torch.randn(
        v.shape, generator=g)) for k, v in tree.items()}


@pytest.mark.parametrize("case", ["d16-model2", "d16-model4", "30-heads-model4"])
def test_merge_of_the_shards_is_the_tree_bit_for_bit(case):
    """d16's widths (two layers, C=1024, 16 heads of 64) at model 2 and 4,
    and a 30-head tree at model 4, whose attention stays whole."""
    if case.startswith("d16"):
        cfg = dataclasses.replace(
            control_var_config_from_depth(16, multi_cond=True, cos_attn=True), depth=2)
        model = int(case[-1])
    else:
        cfg = ControlVARConfig(depth=2, embed_dim=240, num_heads=30, patch_nums=(1, 2),
                               vocab_size=64, cvae=8, num_classes=4, multi_cond=True,
                               cos_attn=True)
        model = 4
    tree = _random_tree(cfg)
    mc = MeshConfig(data=1, model=model)
    shards = [shard_params(mc, tree, j, cfg) for j in range(model)]
    merged = merge_shards(shards, cfg)
    flat, got = dict(named_leaves(tree)), dict(named_leaves(merged))
    assert sorted(flat) == sorted(got)
    for name, t in flat.items():
        assert torch.equal(got[name], t), name
    cut_names = {n for n in flat if leaf_split(n, cfg, model) is not None}
    heads = {"blocks/qkv_kernel", "blocks/q_bias", "blocks/v_bias", "blocks/proj/kernel",
             "blocks/scale_mul"}
    mlp_ada = {"blocks/fc1/kernel", "blocks/fc1/bias", "blocks/fc2/kernel",
               "blocks/ada_lin/kernel", "blocks/ada_lin/bias"}
    if case.startswith("d16"):
        assert cut_names == heads | mlp_ada | {"head/kernel", "head/bias"}
        assert shards[0]["blocks"]["qkv_kernel"].shape[-1] == 3 * 1024 // model
        # whole heads within each of q, k and v
        qkv = tree["blocks"]["qkv_kernel"].reshape(2, 1024, 3, 16, 64)
        per = 16 // model
        want = qkv[:, :, :, per: 2 * per].reshape(2, 1024, -1)
        assert torch.equal(shards[1]["blocks"]["qkv_kernel"], want)
    else:  # 30 heads % 4: the attention stays whole, the MLP and ada_lin split
        assert cut_names == mlp_ada | {"head/kernel", "head/bias"}
        assert shards[3]["blocks"]["qkv_kernel"].shape == tree["blocks"]["qkv_kernel"].shape


def test_contiguous_cuts_follow_the_rule_table():
    """Where a leaf is cut contiguously (or by heads that span whole rows),
    it is cut on the dimension param_shardings names for 'model'."""
    cfg = ControlVARConfig(**TINY)
    tree = ControlVARModel(cfg, device="cpu").init_params(0)
    spec_tree = tmesh.param_shardings(MeshConfig(1, 2), tree)

    def spec_of(name):
        node = spec_tree
        for k in name.split("/"):
            node = node[k]
        return node

    for name, _ in named_leaves(tree):
        s = leaf_split(name, cfg, 2)
        if s is None:
            assert "model" not in spec_of(name) or name == "blocks/scale_mul", name
        else:
            assert spec_of(name)[s.dim] == "model", name


def test_shard_opt_state_cuts_the_moments():
    """A whole AdamW state cut to a shard holds the shard's slices of the
    moments (`cut` of each whole moment), and the step counts."""
    cfg = ControlVARConfig(**TINY)
    tree = ControlVARModel(cfg, device="cpu").init_params(0)
    for _, leaf in named_leaves(tree):
        leaf.grad = torch.randn_like(leaf)
    optim = OptimConfig(base_lr=1e-2, total_batch_size=512)
    state = init_train_state(tree, optim)
    state.optimizer.step()
    mc = tmesh.Mesh(data=1, model=2, model_index=1)
    shard = shard_params(mc, tree, 1, cfg)
    opt = init_train_state(shard, optim).optimizer
    opt.load_state_dict(shard_opt_state(mc, state.optimizer.state_dict(), shard, cfg))
    whole = dict(named_leaves(tree))
    for name, leaf in named_leaves(shard):
        s = leaf_split(name, cfg, 2)
        want = state.optimizer.state[whole[name]]
        for key in ("exp_avg", "exp_avg_sq"):
            w = want[key] if s is None else cut(want[key], s, 2, 1)
            assert torch.equal(opt.state[leaf][key], w), (name, key)
        assert torch.equal(opt.state[leaf]["step"], want["step"])


def test_trainer_generator_follows_the_data_index():
    """The ranks of a model group draw the same drop-path and cond-drop
    masks; data shards draw apart."""
    tr = trainer_mod.Trainer(
        ControlVARConfig(**TINY), VQVAEConfig(**VQ), OptimConfig(),
        Loader(SyntheticControlDataset(image_size=64, num_classes=8, patch_nums=(1, 2, 4),
                                       length=8), batch_size=2), {}, device="cpu")
    draws = {}
    for d, m in ((0, 0), (0, 1), (1, 0)):
        tr.mesh = tmesh.Mesh(data=2, model=2, data_index=d, model_index=m)
        draws[d, m] = torch.rand(4, generator=tr._generator(3))
    assert torch.equal(draws[0, 0], draws[0, 1])
    assert not torch.equal(draws[0, 0], draws[1, 0])


def test_make_mesh_guards():
    assert tmesh.make_mesh(model=1) == MeshConfig(1, 1)
    with pytest.raises(ValueError, match="needs 2 processes"):
        tmesh.make_mesh(model=2)
    # any model axis runs a model: at model 3, C = 250 (MLP width 1000, 5
    # heads, V 64) cuts only ada_lin (6C = 1500), as param_shardings would
    cfg3 = ControlVARConfig(**dict(TINY, embed_dim=250, num_heads=5))
    model3 = ControlVARModel(cfg3, device="cpu", mesh=tmesh.Mesh(data=1, model=3))
    assert model3.tp.model == 3
    assert {n for n, _ in named_leaves(model3.init_params(0)) if leaf_split(n, cfg3, 3)} == {
        "blocks/ada_lin/kernel", "blocks/ada_lin/bias"}
    mesh = tmesh.Mesh(data=1, model=2)
    assert mesh == MeshConfig(1, 2) and MeshConfig(1, 2) == mesh and mesh != MeshConfig(2, 1)
    assert tmesh.replicated(mesh) == () and tmesh.batch_sharding(mesh) == ("data",)
    assert tmesh.tp_of(mesh) is mesh and tmesh.tp_of(tmesh.Mesh()) is None


OUT_OF_SLICE = {
    "var_model": lambda m: VARModel(control_var_config_from_depth(2), device="cpu", mesh=m),
    "kv_window": lambda m: StepwiseJointSampler(_tp_model(m), VQVAE(VQVAEConfig(**VQ),
                                                                    device="cpu"),
                                                cache_mode="seg", kv_window=1, device="cpu"),
    "inplace_decode": lambda m: StepwiseCondSampler(_tp_model(m), VQVAE(VQVAEConfig(**VQ),
                                                                        device="cpu"),
                                                    inplace_decode=True, device="cpu"),
    "kv_fused": lambda m: StepwiseJointSampler(_tp_model(m), VQVAE(VQVAEConfig(**VQ),
                                                                   device="cpu"),
                                               kv_fused=True, device="cpu"),
    "flat_layout": lambda m: StepwiseJointSampler(
        ControlVARModel(ControlVARConfig(**dict(TINY, embed_dim=256, num_heads=2)),
                        device="cpu", mesh=m), VQVAE(VQVAEConfig(**VQ), device="cpu"),
        device="cpu"),
    "separate_decoding": lambda m: ControlVARModel(
        ControlVARConfig(**dict(TINY, separate_decoding=True)), device="cpu",
        mesh=m).sample_joint_separate(None, None, None, None, None, None),
}


def _tp_model(mesh):
    return ControlVARModel(ControlVARConfig(**TINY), device="cpu", mesh=mesh)


@pytest.mark.parametrize("mode", list(OUT_OF_SLICE))
def test_out_of_slice_modes_raise(mode):
    mesh = tmesh.Mesh(data=1, model=2)
    with pytest.raises(NotImplementedError):
        OUT_OF_SLICE[mode](mesh)
