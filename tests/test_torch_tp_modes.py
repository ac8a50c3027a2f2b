"""The Trainer's remaining model-axis modes of the port against the JAX
package's mesh runs and the port's one-process runs, on the CPU: LoRA over
a tensor-parallel base, the separator, type_pos, shared_aln and
bidirectional models, from-tokens steps and gradient accumulation.

Config: ControlVAR depth 2, C=256, 4 heads of 64, patch_nums (1, 2, 4),
multi_cond, fp32, as tests/test_torch_tp.py, but V=66: the separator
model's head then has 70 columns, which model=2 divides and model=4 does
not, as d16's 4114 (4096 + 18); one model per option,
the port's init carried to the JAX layout by `to_jax_params`, every bias
random (zero at init, it would hide a bias added on each rank before a
row-parallel sum) and the AdaLN gates raised (attention by 10, FFN by 1),
so that every layer's attention moves the draws. The LoRA factors are
rank 4 with every B random: with B = 0 (the LoRA init) A gets no gradient
and a missing model-group sum of its gradient would not show. Two gloo
worlds run together, one subprocess a rank (tests/torch_tp_modes_worker.py):
model=2 (two ranks) and data=2 x model=2 (four ranks, which also run the
separator model at model=4, where its head stays whole). They
are held against:
  - one JAX `ControlVARTrainStep` from-tokens step on its 8-device CPU
    mesh at data=4, model=2 for each option (bidirectional in the
    image-first order): params within 1e-5 absolute, loss within 1e-5 and
    grad_norm within 1e-4 relative, the port-to-JAX tolerances of
    tests/test_torch_train_step.py; and the port's step on one process:
    params within 2e-6 absolute, loss within 1e-6 and grad_norm within
    1e-5 relative, the tolerances of tests/test_torch_tp.py, and the
    clipped gradients within 1e-5 of each leaf's largest. AdamW's first
    step moves a param by lr g / (|g| + eps): where the one-process |g| is
    below eps = 1e-8 (ten of 131,072 elements of the separator model's
    proj kernel, at ~1e-6 of its largest gradient) that ratio follows the
    fp32 reassociation noise of g, so those params are held within lr of
    each other and the gradients within the limit above;
  - JAX `sample_joint_cfg` of the separator and type_pos models on the
    data=2, model=4 mesh, and the JAX `StepwiseCondSampler` of the
    shared_aln and bidirectional ones: greedy (top_k=1) ids bit for bit and
    f_hats within 1e-4 absolute;
  - one JAX `LoRAControlVARTrainStep` step on the data=4, model=2 mesh, the
    base placed by `param_shardings` and the factors replicated, as the JAX
    Trainer places them: loss within 1e-5, grad_norm within 1e-4 relative,
    factors within 1e-5 absolute (tests/test_torch_lora.py); the port's
    one-process LoRA step at the tolerances above, and the factors bit-equal
    on every rank;
  - the port's one-process from-tokens and pixel steps with accum=2 and
    random ignore masks, at the one-process tolerances.
`Trainer(model_axis=2, lora_rank=4)` checkpoints hold the whole factors and
their moments and cross the model axis both ways; a bidirectional Trainer
takes one stream order for the whole world each step; `cli.main train
--model_axis 2` runs with --lora, with the options, and from token shards
with --grad_accum 2. The LoRA delta's cut is checked bit for bit without a
process group at d16 widths."""
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

import controlvar_tpu.eval.stepwise as j_stepwise
import controlvar_tpu.models.control_var as j_control_var
from controlvar_tpu.ckpt import lora as jlora
from controlvar_tpu.config import ControlVARConfig as JCfg
from controlvar_tpu.config import OptimConfig as JOptim
from controlvar_tpu.config import VQVAEConfig as JVQCfg
from controlvar_tpu.models.control_var import ControlVARModel as JModel
from controlvar_tpu.models.vqvae import VQVAE as JVQVAE
from controlvar_tpu.parallel.mesh import make_mesh as j_make_mesh
from controlvar_tpu.parallel.mesh import param_shardings as j_param_shardings
from controlvar_tpu.train.train_step import ControlVARTrainStep as JTrainStep
from controlvar_tpu.train.train_step import LoRAControlVARTrainStep as JLoRAStep
from controlvar_tpu.train.train_step import init_train_state as j_init_train_state

from controlvar_tpu_torch.ckpt.convert import to_jax_params
from controlvar_tpu_torch.ckpt.lora import LoRAConfig, apply_lora, init_lora_params
from controlvar_tpu_torch.ckpt.orbax_io import CheckpointIO
from controlvar_tpu_torch.config import (ControlVARConfig, OptimConfig, VQVAEConfig,
                                         control_var_config_from_depth)
from controlvar_tpu_torch.data.build import Loader
from controlvar_tpu_torch.data.imagenetc import SyntheticControlDataset
from controlvar_tpu_torch.data.shards import write_token_shard
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.parallel import mesh as tmesh
from controlvar_tpu_torch.parallel.tensor import (cut, leaf_split, lora_cut_keys, merge_shards,
                                                  shard_params)
from controlvar_tpu_torch.train import trainer as trainer_mod
from controlvar_tpu_torch.train.param_groups import named_leaves
from controlvar_tpu_torch.train.train_step import (ControlVARTrainStep, LoRAControlVARTrainStep,
                                                   init_train_state)
from tests.torch_world import World

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_tp_modes_worker.py")
VQ = dict(ch=32, patch_nums=(1, 2, 4), vocab_size=66)
TINY = dict(depth=2, embed_dim=256, num_heads=4, patch_nums=(1, 2, 4), vocab_size=66,
            cvae=32, num_classes=8, mask_factor=2, multi_cond=True, cond_drop_rate=0.0)
OPTIONS = {o: dict(TINY, **{o: True})
           for o in ("separator", "type_pos", "shared_aln", "bidirectional")}
JOINT = ("separator", "type_pos")  # the others sample through StepwiseCondSampler
LORA_RANK = 4
B_SAMPLE, B_TRAIN = 2, 8
L_PLAIN = 2 * sum(p * p for p in TINY["patch_nums"])  # separator-free ignore masks
WORLDS = ((2, 2), (4, 2))  # (processes, model axis)
OPTIM = dict(base_lr=1e-2, total_batch_size=512, grad_clip=1.0)


class _JFp32Model(JModel):
    def forward_train(self, *args, **kwargs):
        return super().forward_train(*args, compute_dtype=jnp.float32, **kwargs)


class _JFp32Step(JTrainStep):
    tokenize_dtype = jnp.float32


class _Fp32Step(ControlVARTrainStep):
    tokenize_dtype = torch.float32
    compute_dtype = torch.float32


def _params(kw, rng):
    """The port's init of a config with every bias random and the gates
    raised (ada_gss under shared_aln)."""
    cfg = ControlVARConfig(**kw)
    tree = ControlVARModel(cfg, device="cpu").init_params(1)
    for name, leaf in named_leaves(tree):
        if name.endswith("bias"):
            leaf += torch.from_numpy(rng.normal(0.0, 0.02, tuple(leaf.shape)).astype(np.float32))
    gates = tree["blocks"]["ada_gss"][:, 0] if cfg.shared_aln else (
        tree["blocks"]["ada_lin"]["bias"].view(cfg.depth, 6, -1)[:, 0])
    gates += 10.0
    gates = tree["blocks"]["ada_gss"][:, 1] if cfg.shared_aln else (
        tree["blocks"]["ada_lin"]["bias"].view(cfg.depth, 6, -1)[:, 1])
    gates += 1.0
    return tree


def _tokens(rng, B, vocab, ignore=False):
    ids = lambda: [torch.from_numpy(rng.integers(0, vocab, (B, p * p)))
                   for p in TINY["patch_nums"]]
    out = dict(ctrl_ids=ids(), img_ids=ids(), cls=torch.from_numpy(rng.integers(0, 8, (B,))),
               type=torch.from_numpy(rng.integers(0, 4, (B,))))
    if ignore:
        out["ignore_mask"] = torch.from_numpy((rng.random((B, L_PLAIN)) < 0.7)
                                              .astype(np.float32))
    return out


def _inputs():
    """Every tree and batch, from seeds."""
    rng = np.random.default_rng(0)
    params = {o: _params(kw, rng) for o, kw in OPTIONS.items()}
    vq_params = VQVAE(VQVAEConfig(**VQ), device="cpu").init_params(0)
    base = _params(TINY, rng)
    factors = init_lora_params(torch.Generator().manual_seed(2), base, LoRAConfig(LORA_RANK))
    for ab in factors.values():
        ab["B"] = torch.from_numpy(rng.normal(0, 0.01, tuple(ab["B"].shape)).astype(np.float32))
    img = lambda: torch.from_numpy((rng.random((B_TRAIN, 64, 64, 3)) * 2 - 1)
                                   .astype(np.float32))
    ign = lambda: torch.from_numpy((rng.random((B_TRAIN, L_PLAIN)) < 0.7).astype(np.float32))
    pixels = dict(image=img(), mask=img(), cls=torch.from_numpy(rng.integers(0, 8, (B_TRAIN,))),
                  type=torch.from_numpy(rng.integers(0, 4, (B_TRAIN,))), ignore_mask=ign(),
                  ignore_mask_=ign())
    return dict(cfgs=OPTIONS, params=params, vq_cfg=VQ, vq_params=vq_params,
                tokens=_tokens(rng, B_TRAIN, VQ["vocab_size"]),
                tokens_ign=_tokens(rng, B_TRAIN, VQ["vocab_size"], ignore=True),
                pixels_ign=pixels,
                lora=dict(cfg=TINY, rank=LORA_RANK, base=base, factors=factors),
                forced=[torch.from_numpy(rng.integers(0, VQ["vocab_size"], (B_SAMPLE, p * p)))
                        for p in VQ["patch_nums"]],
                labels=torch.tensor([1, 5]), ct=torch.tensor([0, 2]))


def _write_shards(directory, rng):
    """Four token shards of two rows for the CLI (V = 4096)."""
    os.makedirs(directory)
    for i in range(4):
        t = _tokens(rng, 2, 4096, ignore=True)
        write_token_shard(os.path.join(directory, f"tokens_{i:03d}.npz"),
                          [x.numpy() for x in t["ctrl_ids"]], [x.numpy() for x in t["img_ids"]],
                          t["cls"].numpy(), t["type"].numpy(), t["ignore_mask"].numpy())


def _vq_to_jax(tree):
    """The port's VQVAE tree as numpy in the JAX layout (OIHW -> HWIO)."""
    if isinstance(tree, dict):
        return {k: (v.numpy().transpose(2, 3, 1, 0) if k == "kernel" else _vq_to_jax(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_vq_to_jax(v) for v in tree]
    return tree.numpy()


def _jax_batch(batch, sharding):
    def put(v):
        if isinstance(v, list):
            return [put(t) for t in v]
        v = v.numpy()
        return jax.device_put(jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i" else v),
                              sharding)

    return {k: put(v) for k, v in batch.items()}


def _spy(module, ids):
    orig = module.sample_top_k_top_p

    def spy(*a, **kw):
        r = orig(*a, **kw)
        jax.debug.callback(lambda x: ids.append(np.asarray(x)), r)
        return r

    module.sample_top_k_top_p = spy
    return orig


def _jax_runs(inp):
    """The JAX references: each option's step on the 4x2 mesh, the joint
    samplers on the 2x4 mesh, the conditional samplers, the LoRA step."""
    devices = jax.devices()
    jv = JVQVAE(JVQCfg(**VQ))
    jvp = _vq_to_jax(inp["vq_params"])
    labels, ct = (jnp.asarray(inp[k].numpy(), jnp.int32) for k in ("labels", "ct"))
    out = {}
    mesh24 = j_make_mesh(data=2, model=4, devices=devices)
    mesh42 = j_make_mesh(data=4, model=2, devices=devices)
    optim = JOptim(**OPTIM)
    for option, kw in OPTIONS.items():
        jp = to_jax_params(inp["params"][option], ControlVARConfig(**kw))
        jm = JModel(JCfg(**kw))
        if option in JOINT:
            ids = []
            orig = _spy(j_control_var, ids)
            repl = NamedSharding(mesh24, P())
            try:
                with mesh24:
                    fh = jax.jit(lambda p, vp, k: jm.sample_joint_cfg(
                        p, jv, vp, labels, ct, k, cfg_scale=2.0, top_k=1, top_p=0.0,
                        compute_dtype=jnp.float32, decode_img=False))(
                        jax.device_put(jp, j_param_shardings(mesh24, jp)),
                        jax.device_put(jvp, jax.tree_util.tree_map(lambda _: repl, jvp)),
                        jax.random.key(7))
                    fh = [np.asarray(t) for t in fh]
                jax.effects_barrier()
            finally:
                j_control_var.sample_top_k_top_p = orig
        else:
            ids = []
            orig = _spy(j_stepwise, ids)
            try:
                js = j_stepwise.StepwiseCondSampler(jm, jv, cfg_scales=(2.0, 2.0, 2.0), top_k=1,
                                                    top_p=0.0)
                js.compute_dtype = jnp.float32
                fh = [np.asarray(t) for t in js(
                    jp, jvp, labels, ct, jax.random.key(8),
                    [jnp.asarray(f.numpy(), jnp.int32) for f in inp["forced"]],
                    decode_img=False)]
                jax.effects_barrier()
            finally:
                j_stepwise.sample_top_k_top_p = orig
        # unordered callbacks: each scale's draw has a width of its own
        out[f"sample/{option}"] = (sorted(ids, key=lambda a: a.shape[1]), fh)
        stepper = _JFp32Step(_JFp32Model(JCfg(**kw)), jv, optim, max_steps=100, warmup_steps=1)
        state, tx = j_init_train_state(jp, optim)
        repl, batch_sh = NamedSharding(mesh42, P()), NamedSharding(mesh42, P("data"))
        state = state._replace(params=jax.device_put(state.params,
                                                     j_param_shardings(mesh42, state.params)))
        mask_first = option != "bidirectional"
        with mesh42:
            state, aux = jax.jit(lambda s, vp, b, k: stepper.step(
                tx, s, vp, b, k, mask_first, from_tokens=True))(
                state, jax.device_put(jvp, jax.tree_util.tree_map(lambda _: repl, jvp)),
                _jax_batch(inp["tokens"], batch_sh), jax.random.key(5))
        out[f"step/{option}"] = (_jax_leaves(state.params), float(aux["loss"]),
                                 float(aux["grad_norm"]))
    # the LoRA step: the base cut by param_shardings, the factors replicated
    jp = to_jax_params(inp["lora"]["base"], ControlVARConfig(**TINY))
    jl = jax.tree_util.tree_map(lambda t: t.numpy(), inp["lora"]["factors"])
    stepper = JLoRAStep(_JFp32Step(_JFp32Model(JCfg(**TINY)), jv, optim, max_steps=100,
                                   warmup_steps=1), jlora.LoRAConfig(rank=LORA_RANK))
    state, tx = stepper.init_lora_state(jax.random.key(0), jp, optim)
    repl, batch_sh = NamedSharding(mesh42, P()), NamedSharding(mesh42, P("data"))
    state = state._replace(params=jax.device_put(jl, jax.tree_util.tree_map(lambda _: repl, jl)))
    with mesh42:
        state, aux = jax.jit(lambda s, bp, vp, b, k: stepper.step(
            tx, s, bp, vp, b, k, from_tokens=True))(
            state, jax.device_put(jp, j_param_shardings(mesh42, jp)),
            jax.device_put(jvp, jax.tree_util.tree_map(lambda _: repl, jvp)),
            _jax_batch(inp["tokens"], batch_sh), jax.random.key(5))
    out["lora"] = (_jax_leaves(state.params), float(aux["loss"]), float(aux["grad_norm"]))
    return out


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in path): np.asarray(leaf)
            for path, leaf in flat}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _vqvae():
    return VQVAE(VQVAEConfig(**VQ), device="cpu")


def _one_step(inp, option, batch, mask_first=True, from_tokens=True, accum=1):
    cfg = ControlVARConfig(**OPTIONS[option])
    optim = OptimConfig(**OPTIM)
    step = _Fp32Step(ControlVARModel(cfg, device="cpu"), _vqvae(), optim, max_steps=100,
                     warmup_steps=1, device="cpu")
    state = init_train_state(_clone(inp["params"][option]), optim)
    state, aux = step.step(state, inp["vq_params"], batch, None, mask_first,
                           from_tokens=from_tokens, accum=accum)
    return ({k: v.detach() for k, v in named_leaves(state.params)}, float(aux["loss"]),
            float(aux["grad_norm"]), {k: v.grad for k, v in named_leaves(state.params)},
            aux["lr"])


def _one_lora_step(inp):
    cfg = ControlVARConfig(**TINY)
    optim = OptimConfig(**OPTIM)
    step = LoRAControlVARTrainStep(
        _Fp32Step(ControlVARModel(cfg, device="cpu"), _vqvae(), optim, max_steps=100,
                  warmup_steps=1, device="cpu"), LoRAConfig(rank=LORA_RANK))
    state = step.init_lora_state(torch.Generator().manual_seed(0), inp["lora"]["base"], optim)
    with torch.no_grad():
        for key, ab in state.params.items():
            for f in ("A", "B"):
                ab[f].copy_(inp["lora"]["factors"][key][f])
    state, aux = step.step(state, inp["lora"]["base"], inp["vq_params"], inp["tokens"],
                           from_tokens=True)
    return ({k: v.detach().clone() for k, v in named_leaves(state.params)}, float(aux["loss"]),
            float(aux["grad_norm"]), {k: v.grad.clone() for k, v in named_leaves(state.params)})


def _trainer(ckpt_dir, stop_after, vq_params):
    """A single-device fp32 LoRA Trainer run to step `stop_after`, resuming
    the latest checkpoint in ckpt_dir (the workers run the same loader)."""
    cfg = ControlVARConfig(**TINY)
    ds = SyntheticControlDataset(image_size=64, num_classes=8, patch_nums=cfg.patch_nums,
                                 length=8)
    saved, trainer_mod.ControlVARTrainStep = trainer_mod.ControlVARTrainStep, _Fp32Step
    try:
        tr = trainer_mod.Trainer(cfg, VQVAEConfig(**VQ),
                                 OptimConfig(base_lr=1e-2, total_batch_size=512, epochs=1),
                                 Loader(ds, batch_size=2, num_workers=1), vq_params,
                                 ckpt_dir=ckpt_dir, stop_after=stop_after, lora_rank=LORA_RANK,
                                 log_every=1, log_fn=lambda m: None, device="cpu")
        state, epoch = tr.maybe_resume(tr.init_state(seed=1))
        return tr.fit(state, epoch)
    finally:
        trainer_mod.ControlVARTrainStep = saved


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' per-rank results beside the JAX and one-process ones."""
    d = tmp_path_factory.mktemp("tp_modes")
    inp = _inputs()
    torch.save(inp, d / "inputs.pt")
    _write_shards(d / "shards", np.random.default_rng(1))
    # the single-device LoRA checkpoint at step 1 that a tensor-parallel
    # Trainer resumes
    _trainer(str(d / "one_ckpt"), 1, inp["vq_params"])
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "DIST_BACKEND")}
    env["OMP_NUM_THREADS"] = "1"
    worlds = []
    for world, _ in WORLDS:
        wd = d / f"world{world}"

        def prepare(wd=wd):
            shutil.rmtree(wd, ignore_errors=True)
            os.makedirs(wd / "one_to_tp_lora")
            shutil.copy(d / "one_ckpt" / "1.pt", wd / "one_to_tp_lora" / "1.pt")
            for name in ("inputs.pt", "shards"):
                os.symlink(d / name, wd / name)

        # world 2's three more ports are its CLI runs' groups
        worlds.append(World(lambda ports, world=world, wd=wd: [
            [sys.executable, WORKER, str(r), str(world), ports[0], str(wd), *ports[1:]]
            for r in range(world)], n_ports=4 if world == 2 else 1, env=env, prepare=prepare))
    try:
        ref = _jax_runs(inp)
        one = {o: _one_step(inp, o, inp["tokens"], mask_first=o != "bidirectional")
               for o in OPTIONS}
        one["accum/tokens"] = _one_step(inp, "separator", inp["tokens_ign"], accum=2)
        one["accum/pixels"] = _one_step(inp, "separator", inp["pixels_ign"], from_tokens=False,
                                        accum=2)
        one["tokens_ign/accum1"] = _one_step(inp, "separator", inp["tokens_ign"])
        one["lora"] = _one_lora_step(inp)
        one["lora_resumed"] = _trainer(str(d / "one_ckpt"), 2, inp["vq_params"])
        logs = [log for w in worlds for log in w.wait(300)]
    finally:
        for w in worlds:
            w.kill()
    # the single-device Trainer resumes the tensor-parallel LoRA checkpoint
    os.makedirs(d / "tp_to_one")
    shutil.copy(d / "world2" / "lora_ckpt" / "1.pt", d / "tp_to_one" / "1.pt")
    one["tp_to_one"] = _trainer(str(d / "tp_to_one"), 2, inp["vq_params"])
    ranks = {world: [torch.load(d / f"world{world}" / f"rank{r}_of{world}.pt",
                                weights_only=True) for r in range(world)]
             for world, _ in WORLDS}
    return dict(ref=ref, one=one, ranks=ranks, dir=d, logs=logs)


# ---- the option models -------------------------------------------------------

def _check_one(got, want_one):
    """A tensor-parallel step against the one-process step."""
    params, _, loss, norm, grads = got
    oparams, oloss, onorm, ograds, lr = want_one
    assert sorted(params) == sorted(oparams) == sorted(grads)
    for name in params:
        g = ograds[name].numpy()
        np.testing.assert_allclose(grads[name].numpy(), g, atol=1e-5 * np.abs(g).max(),
                                   rtol=0, err_msg=name)
        # below Adam's eps the update follows g's noise (module docstring)
        atol = np.where(np.abs(g) < 1e-8, lr, 2e-6)
        np.testing.assert_array_less(np.abs(params[name].numpy() - oparams[name].numpy()),
                                     atol + 1e-12, err_msg=name)
    np.testing.assert_allclose(loss, oloss, rtol=1e-6)
    np.testing.assert_allclose(norm, onorm, rtol=1e-5)


def _check_step(got, want_jax, want_one):
    """A tensor-parallel step against the JAX mesh step and the one-process
    step."""
    params, _, loss, norm, _ = got
    jparams, jloss, jnorm = want_jax
    assert sorted(params) == sorted(jparams)
    for name in params:
        np.testing.assert_allclose(params[name].numpy(), jparams[name], atol=1e-5, rtol=0,
                                   err_msg=name)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    np.testing.assert_allclose(norm, jnorm, rtol=1e-4)
    _check_one(got, want_one)


@pytest.mark.parametrize("world", [w for w, _ in WORLDS])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_step_matches_jax_mesh_and_one_process(runs, world, option):
    """One from-tokens step of each option's model (bidirectional in the
    image-first order) on every rank: the JAX mesh step and the port's
    one-process step."""
    for out in runs["ranks"][world]:
        _check_step(out[f"step/{option}"], runs["ref"][f"step/{option}"], runs["one"][option])


@pytest.mark.parametrize("world", [w for w, _ in WORLDS])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_ranks_hold_equal_whole_leaves_and_gathered_params(runs, world, option):
    """Every rank of the world holds the same whole leaves (the option's
    special_embed, type_embed, shared_ada_lin and ada_gss among them) and
    gathers the same params, bit for bit."""
    outs = runs["ranks"][world]
    first_params, first_whole = outs[0][f"step/{option}"][:2]
    extra = {"separator": "special_embed", "type_pos": "type_embed",
             "shared_aln": "blocks/ada_gss", "bidirectional": "pos_start"}[option]
    assert extra in first_whole
    if option == "shared_aln":
        assert "shared_ada_lin/kernel" in first_whole and "blocks/ada_lin/kernel" not in (
            first_params)
    for out in outs[1:]:
        params, whole = out[f"step/{option}"][:2]
        for name, t in whole.items():
            assert torch.equal(t, first_whole[name]), name
        for name, t in params.items():
            assert torch.equal(t, first_params[name]), name


def _check_sample(got, want):
    ids, fh = got
    want_ids, want_fh = want
    assert len(ids) == len(want_ids) == len(VQ["patch_nums"])
    for si, (a, b) in enumerate(zip(ids, want_ids)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f"scale {si}")
    for a, b in zip(fh, want_fh):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=0)


@pytest.mark.parametrize("world", [w for w, _ in WORLDS])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_greedy_ids_equal_jax_bit_for_bit(runs, world, option):
    """Greedy sampling of each option's model on every rank: the separator
    and type_pos models through sample_joint_cfg (StepwiseJointSampler)
    against JAX sample_joint_cfg on sharded params, the shared_aln and
    bidirectional ones through StepwiseCondSampler against JAX's."""
    for out in runs["ranks"][world]:
        _check_sample(out[f"sample/{option}"], runs["ref"][f"sample/{option}"])
    if option == "separator":  # the draws carry the separator slots, cut to V
        widths = [ids.shape[1] for ids in runs["ranks"][world][0]["sample/separator"][0]]
        assert widths == [2, 10, 34]


def test_separator_head_is_cut_at_model_2_and_whole_at_model_4(runs):
    """70 head columns: 35 a rank at model=2, all 70 at model=4, where the
    step and the joint sampler still match JAX and one process."""
    assert leaf_split("head/kernel", ControlVARConfig(**OPTIONS["separator"]), 4) is None
    for world in (2, 4):
        assert all(out["head_cols"] == 35 for out in runs["ranks"][world])
    for out in runs["ranks"][4]:
        assert out["head_cols4"] == 70
        _check_step(out["step4/separator"], runs["ref"]["step/separator"],
                    runs["one"]["separator"])
        _check_sample(out["sample4/separator"], runs["ref"]["sample/separator"])


# ---- from tokens and gradient accumulation ------------------------------------

@pytest.mark.parametrize("world", [w for w, _ in WORLDS])
@pytest.mark.parametrize("kind", ["tokens", "pixels"])
def test_accum_steps_match_one_process(runs, world, kind):
    """accum=2 from tokens and from pixels under random ignore masks: the
    one-process accum=2 step; from tokens also the one-process accum=1 step
    (the microbatches' loss weight is the global batch's)."""
    for out in runs["ranks"][world]:
        _check_one(out[f"accum/{kind}"], runs["one"][f"accum/{kind}"])
        loss, norm = out[f"accum/{kind}"][2:4]
        if kind == "tokens":
            whole = runs["one"]["tokens_ign/accum1"]
            np.testing.assert_allclose(loss, whole[1], rtol=1e-5)
            np.testing.assert_allclose(norm, whole[2], rtol=1e-4)


# ---- LoRA ---------------------------------------------------------------------

@pytest.mark.parametrize("world", [w for w, _ in WORLDS])
def test_lora_step_matches_jax_mesh_and_one_process(runs, world):
    jfactors, jloss, jnorm = runs["ref"]["lora"]
    ofactors, oloss, onorm, ograds = runs["one"]["lora"]
    for out in runs["ranks"][world]:
        factors, grads, loss, norm, base_unchanged = out["lora"]
        assert base_unchanged
        assert sorted(factors) == sorted(jfactors) == sorted(ofactors)
        for name, t in factors.items():
            np.testing.assert_allclose(t.numpy(), jfactors[name], atol=1e-5, rtol=0,
                                       err_msg=name)
            np.testing.assert_allclose(t.numpy(), ofactors[name].numpy(), atol=2e-6, rtol=0,
                                       err_msg=name)
            w = ograds[name].numpy()
            np.testing.assert_allclose(grads[name].numpy(), w, atol=1e-5 * np.abs(w).max(),
                                       rtol=0, err_msg=name)
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        np.testing.assert_allclose(norm, jnorm, rtol=1e-4)
        np.testing.assert_allclose(loss, oloss, rtol=1e-6)
        np.testing.assert_allclose(norm, onorm, rtol=1e-5)
    # every A moved by its gradient: B is random
    assert all(float(ograds[k].abs().max()) > 0 for k in ograds if k.endswith("/A"))


@pytest.mark.parametrize("world", [w for w, _ in WORLDS])
def test_lora_factors_are_bit_equal_on_every_rank(runs, world):
    outs = runs["ranks"][world]
    for out in outs[1:]:
        for name, t in out["lora"][0].items():
            assert torch.equal(t, outs[0]["lora"][0][name]), name
            assert torch.equal(out["lora"][1][name], outs[0]["lora"][1][name]), name


def _d16(model_heads):
    if model_heads == "30-heads":
        return ControlVARConfig(depth=2, embed_dim=240, num_heads=30, patch_nums=(1, 2),
                                vocab_size=64, cvae=8, num_classes=4, multi_cond=True)
    return dataclasses.replace(control_var_config_from_depth(16, multi_cond=True), depth=2)


@pytest.mark.parametrize("case", ["d16-model2", "d16-model4", "30-heads-model4"])
def test_lora_delta_cut_bit_for_bit(case):
    """Without a process group: each rank's kernels under apply_lora are
    `cut` of the whole tree's under apply_lora, bit for bit, and merge back
    to it; proj stays whole with 30 heads at model 4, head_nm's ada_lin
    always."""
    cfg = _d16("30-heads" if case.startswith("30") else "d16")
    model = int(case[-1])
    g = torch.Generator().manual_seed(0)
    base = ControlVARModel(cfg, device="cpu").init_params(0)
    lcfg = LoRAConfig(rank=4)
    lora = init_lora_params(g, base, lcfg)
    for ab in lora.values():
        ab["B"] = torch.randn(ab["B"].shape, generator=g) * 0.01
    whole = apply_lora(base, lora, lcfg)
    shards = []
    for j in range(model):
        mesh = tmesh.Mesh(data=1, model=model, model_index=j)
        shard = apply_lora(shard_params(mesh, base, j, cfg), lora, lcfg, mesh=mesh,
                           model_cfg=cfg)
        shards.append(shard)
        flat, want = dict(named_leaves(shard)), dict(named_leaves(whole))
        for key in lora:
            s = leaf_split(key, cfg, model)
            w = want[key] if s is None else cut(want[key], s, model, j)
            assert torch.equal(flat[key], w), (key, j)
    merged = dict(named_leaves(merge_shards(shards, cfg)))
    for name, t in named_leaves(whole):
        assert torch.equal(merged[name], t.detach()), name
    cut_keys = set(lora_cut_keys(lora, cfg, model))
    attn = {"blocks/proj/kernel"} if cfg.num_heads % model == 0 else set()
    assert cut_keys == attn | {"blocks/fc1/kernel", "blocks/fc2/kernel",
                               "blocks/ada_lin/kernel"}


def test_lora_factors_from_a_shard_are_refused_and_shared_aln_has_no_ada_lin():
    """Factors made from a shard have the shard's fan_in and widths: the
    delta does not fit, and apply_lora says so. Under shared_aln the blocks
    have no ada_lin, and no factors are made for it."""
    cfg = ControlVARConfig(**TINY)
    mesh = tmesh.Mesh(data=1, model=2, model_index=0)
    shard = shard_params(mesh, ControlVARModel(cfg, device="cpu").init_params(0), 0, cfg)
    lora = init_lora_params(torch.Generator().manual_seed(0), shard, LoRAConfig(rank=4))
    with pytest.raises(ValueError, match="made from the whole tree"):
        apply_lora(shard, lora, LoRAConfig(rank=4), mesh=mesh, model_cfg=cfg)
    shared = ControlVARModel(ControlVARConfig(**OPTIONS["shared_aln"]),
                             device="cpu").init_params(0)
    keys = init_lora_params(torch.Generator().manual_seed(0), shared, LoRAConfig(rank=4))
    assert "blocks/ada_lin/kernel" not in keys and "head_nm/ada_lin/kernel" in keys


@pytest.mark.parametrize("case", ["tp_to_one", "one_to_tp"])
def test_lora_checkpoints_cross_the_model_axis(runs, case):
    """Trainer(model_axis=2, lora_rank=4): its step-1 checkpoint resumed by a
    single-device Trainer takes the step the tensor-parallel run took, and
    the reverse; the checkpoints hold the whole factors and moments."""
    d = runs["dir"]
    if case == "tp_to_one":
        got = runs["one"]["tp_to_one"]
        want_raw, _ = CheckpointIO(str(d / "world2" / "lora_ckpt")).restore_raw(2)
        for out in runs["ranks"][2]:
            step, factors = out["lora_trainer"]
            assert step == 2
            for name, t in factors.items():
                assert np.array_equal(t.numpy(), dict(named_leaves(want_raw["params"]))[name])
    else:
        got = runs["one"]["lora_resumed"]
        want_raw, _ = CheckpointIO(str(d / "world2" / "one_to_tp_lora")).restore_raw(2)
    assert got.step == want_raw["step"] == 2
    want = dict(named_leaves(want_raw["params"]))
    got_p = {k: v.detach().numpy() for k, v in named_leaves(got.params)}
    assert sorted(got_p) == sorted(want)
    assert want["blocks/fc1/kernel/B"].shape == (2, LORA_RANK, 1024)  # whole widths
    for name in want:
        np.testing.assert_allclose(got_p[name], want[name], atol=2e-6, rtol=0, err_msg=name)
    moments = want_raw["optimizer"]["state"]
    assert sum(m["exp_avg"].size for m in moments.values()) == sum(v.size
                                                                   for v in want.values())


# ---- the Trainer's stream order and the command line --------------------------

def test_bidirectional_order_is_one_for_the_world(runs):
    """The four ranks (two data indices) of a bidirectional Trainer take the
    same stream order each step: the coin of np.random.default_rng(1234)."""
    rng = np.random.default_rng(1234)
    want = [not rng.random() < 0.5 for _ in range(4)]
    assert True in want and False in want
    for out in runs["ranks"][4]:
        assert out["orders"] == want


@pytest.mark.parametrize("run", ["lora", "options", "tokens"])
def test_cli_train_with_a_model_axis(runs, run):
    """`cli.main train --model_axis 2` with --lora 4, with --separator
    --type_pos --bidirectional, and from token shards with --grad_accum 2:
    two steps each, logged by the primary; whole checkpoints."""
    raw, _ = CheckpointIO(str(runs["dir"] / "world2" / f"cli_{run}")).restore_raw()
    assert raw["step"] == 2
    p = raw["params"]
    if run == "lora":
        assert p["blocks/fc1/kernel"]["A"].shape == (2, 128, 4)
        assert p["blocks/fc1/kernel"]["B"].shape == (2, 4, 512)
        assert p["head_nm/ada_lin/kernel"]["B"].shape == (4, 256)
    else:
        assert p["head"]["kernel"].shape == (128, 4096 + 4)  # cut at model=2
        assert "special_embed" in p and "type_embed" in p
    log = runs["logs"][0].split(f"cli run {run}")[1].split("cli run")[0]
    assert log.count("loss=") == 2
    assert runs["logs"][1].count("loss=") == 0
