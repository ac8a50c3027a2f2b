"""Model axes beyond 2 against the JAX package's meshes, and the training
forward's `use_flash` flag, on the CPU.

Two gloo worlds run together, one subprocess a rank (tests/torch_tp_worker.py
with inputs.pt's "joint_and_step": the joint draw and one plain step):
  - model = 3 over tests/test_torch_tp.py's tiny config (C 256, 4 heads of
    64, MLP width 1024, V 64): 3 divides 6C = 1536 only, so ada_lin is cut
    and the attention, the MLP and the head stay whole on every rank. The
    port refused such an axis before; the JAX package's `param_shardings`
    replicates every leaf that its axis does not divide, and `leaf_split`
    now does the same;
  - model = 4 over ControlVAR-d30's width cut to one layer (C 1920, 30
    heads of 64, cos_attn with scale_mul drawn uniform in [0, log 200] so
    that some heads clamp at log 100, MLP width 7680; V 64, patch_nums
    (1, 2, 4), ~67 M params): d30's one special case, its attention whole
    (30 % 4 != 0) while the MLP, ada_lin and the head are cut. Its heads
    are d30's 64 wide: a sampler over a model axis takes the paired cache
    only, which needs hd 64.
The weights are the port's init carried to the JAX layout, every bias
random and the AdaLN gates raised (attention by 10, FFN by 1), as in
tests/test_torch_tp.py, whose limits each world is held to against JAX on
a 1 x model mesh of its 8-device CPU platform: greedy `sample_joint_cfg`
ids equal to JAX's one-device draws bit for bit, f_hats within 1e-4 of its
mesh run's; one fp32 ControlVARTrainStep step (lr 1e-2, no random draws)
with params within 1e-5 of the JAX mesh step's, loss within 1e-5 and
grad_norm within 1e-4 relative, and within 2e-6, 1e-6 and 1e-5 of the
port's one-process step; every rank's whole leaves bit-equal, and
`gather_params` of the shards the whole tree bit for bit.

`forward_train(..., use_flash=False)`, which the parity check asks for,
takes attention as the plain einsums of `ops.attention.mha_xla` on any
device: its fp32 logits are held against the JAX package's
`use_flash=False` forward (1e-4 absolute, the port-to-JAX limit of
tests/test_torch_train_step.py) and against the port's default path
(1e-5); `mha_xla` against JAX's `mha_xla` (1e-6); and no module of the
port but `eval/parity.py` passes `use_flash=False`.
"""
import ast
import os
import pathlib
import shutil
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import controlvar_tpu.models.control_var as j_control_var
from controlvar_tpu.config import ControlVARConfig as JCfg
from controlvar_tpu.config import OptimConfig as JOptim
from controlvar_tpu.config import VARConfig as JVARCfg
from controlvar_tpu.config import VQVAEConfig as JVQCfg
from controlvar_tpu.models.control_var import ControlVARModel as JModel
from controlvar_tpu.models.var import VARModel as JVARModel
from controlvar_tpu.models.vqvae import VQVAE as JVQVAE
from controlvar_tpu.ops.attention import mha_xla as j_mha_xla
from controlvar_tpu.parallel.mesh import make_mesh as j_make_mesh
from controlvar_tpu.parallel.mesh import param_shardings as j_param_shardings
from controlvar_tpu.train.train_step import ControlVARTrainStep as JTrainStep
from controlvar_tpu.train.train_step import init_train_state as j_init_train_state

from controlvar_tpu_torch.ckpt.convert import to_jax_params
from controlvar_tpu_torch.config import ControlVARConfig, OptimConfig, VARConfig, VQVAEConfig
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.var import VARModel
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.ops.attention import mha_xla
from controlvar_tpu_torch.parallel.tensor import leaf_split
from controlvar_tpu_torch.train.param_groups import named_leaves
from controlvar_tpu_torch.train.train_step import ControlVARTrainStep, init_train_state
from tests.torch_world import World

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_tp_worker.py")
VQ = dict(ch=32, patch_nums=(1, 2, 4), vocab_size=64)
BASE = dict(depth=2, patch_nums=(1, 2, 4), vocab_size=64, cvae=32, num_classes=8,
            mask_factor=2, multi_cond=True, cond_drop_rate=0.0)
CONFIGS = {  # name: (config, model axis)
    "model3": (dict(BASE, embed_dim=256, num_heads=4), 3),
    "heads30_model4": (dict(BASE, depth=1, embed_dim=1920, num_heads=30, cos_attn=True), 4),
}
# forward_train's use_flash at a cheap width: the tiny config and 30 heads
# of 8 under cos_attn (the training forward takes any head width)
FORWARDS = {"tiny": CONFIGS["model3"][0],
            "heads30_cos_attn": dict(BASE, embed_dim=240, num_heads=30, cos_attn=True)}
B_SAMPLE, B_TRAIN = 2, 8
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
    """The port's init with every bias random and the gates raised; under
    cos_attn, scale_mul uniform in [0, log 200] (some heads clamp)."""
    cfg = ControlVARConfig(**kw)
    tree = ControlVARModel(cfg, device="cpu").init_params(1)
    for name, leaf in named_leaves(tree):
        if name.endswith("bias"):
            leaf += torch.from_numpy(rng.normal(0.0, 0.02, tuple(leaf.shape)).astype(np.float32))
    ada = tree["blocks"]["ada_lin"]["bias"].view(cfg.depth, 6, -1)
    ada[:, 0] += 10.0
    ada[:, 1] += 1.0
    if cfg.cos_attn:
        sm = tree["blocks"]["scale_mul"]
        sm.copy_(torch.from_numpy(rng.uniform(0.0, np.log(200.0), tuple(sm.shape))
                                  .astype(np.float32)))
    return tree


def _vq_to_jax(tree):
    """The port's VQVAE tree as numpy in the JAX layout (OIHW -> HWIO)."""
    if isinstance(tree, dict):
        return {k: (v.numpy().transpose(2, 3, 1, 0) if k == "kernel" else _vq_to_jax(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_vq_to_jax(v) for v in tree]
    return tree.numpy()


def _inputs(kw):
    rng = np.random.default_rng(0)
    params = _params(kw, rng)
    img = lambda: torch.from_numpy((rng.random((B_TRAIN, 64, 64, 3)) * 2 - 1)
                                   .astype(np.float32))
    batch = dict(image=img(), mask=img(), cls=torch.from_numpy(rng.integers(0, 8, (B_TRAIN,))),
                 type=torch.from_numpy(rng.integers(0, 4, (B_TRAIN,))))
    return dict(cfg=kw, vq_cfg=VQ, params=params,
                vq_params=VQVAE(VQVAEConfig(**VQ), device="cpu").init_params(0), batch=batch,
                labels=torch.tensor([1, 5]), ct=torch.tensor([0, 2]), joint_and_step=True)


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in path): np.asarray(leaf)
            for path, leaf in flat}


def _jax_runs(inp, model):
    """JAX's greedy joint call on the 1 x model mesh (f_hats) and on one
    device (the draws), and its train step on the mesh."""
    kw = inp["cfg"]
    jm, jv = JModel(JCfg(**kw)), JVQVAE(JVQCfg(**VQ))
    jp = to_jax_params(inp["params"], ControlVARConfig(**kw))
    jvp = _vq_to_jax(inp["vq_params"])
    mesh = j_make_mesh(data=1, model=model, devices=jax.devices())
    repl = NamedSharding(mesh, P())
    jvp_mesh = jax.device_put(jvp, jax.tree_util.tree_map(lambda _: repl, jvp))
    args = (jnp.asarray(inp["labels"].numpy(), jnp.int32), jnp.asarray(inp["ct"].numpy(),
                                                                       jnp.int32),
            jax.random.key(7))
    sample = jax.jit(lambda p, vp, l, c, k: jm.sample_joint_cfg(
        p, jv, vp, l, c, k, cfg_scale=2.0, top_k=1, top_p=0.0, compute_dtype=jnp.float32,
        decode_img=False))
    out = {}
    with mesh:
        out["joint_fh_mesh"] = [np.asarray(t) for t in sample(
            jax.device_put(jp, j_param_shardings(mesh, jp)), jvp_mesh, *args)]
    ids = []
    orig = j_control_var.sample_top_k_top_p

    def spy(*a, **kw_):
        r = orig(*a, **kw_)
        jax.debug.callback(lambda x: ids.append(np.asarray(x)), r, ordered=True)
        return r

    j_control_var.sample_top_k_top_p = spy
    try:
        out["joint_fh"] = [np.asarray(t) for t in sample(jp, jvp, *args)]
        jax.effects_barrier()
    finally:
        j_control_var.sample_top_k_top_p = orig
    out["joint_ids"] = ids
    optim = JOptim(**OPTIM)
    stepper = _JFp32Step(_JFp32Model(JCfg(**kw)), jv, optim, max_steps=100, warmup_steps=1)
    state, tx = j_init_train_state(jp, optim)
    state = state._replace(params=jax.device_put(state.params,
                                                 j_param_shardings(mesh, state.params)))
    batch_sh = NamedSharding(mesh, P("data"))
    jb = {k: jax.device_put(jnp.asarray(v.numpy().astype(np.int32) if v.dtype == torch.int64
                                        else v.numpy()), batch_sh)
          for k, v in inp["batch"].items()}
    with mesh:
        state, aux = jax.jit(lambda s, vp, b, k: stepper.step(tx, s, vp, b, k))(
            state, jvp_mesh, jb, jax.random.key(5))
    out["step_params"] = _jax_leaves(state.params)
    out["step_aux"] = (float(aux["loss"]), float(aux["grad_norm"]))
    return out


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _one_process_step(inp):
    cfg = ControlVARConfig(**inp["cfg"])
    optim = OptimConfig(**OPTIM)
    step = _Fp32Step(ControlVARModel(cfg, device="cpu"), VQVAE(VQVAEConfig(**VQ), device="cpu"),
                     optim, max_steps=100, warmup_steps=1, device="cpu")
    state = init_train_state(_clone(inp["params"]), optim)
    state, aux = step.step(state, inp["vq_params"], inp["batch"])
    return ({k: v.detach() for k, v in named_leaves(state.params)}, float(aux["loss"]),
            float(aux["grad_norm"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world's per-rank results beside the JAX and one-process ones."""
    d = tmp_path_factory.mktemp("tp_axes")
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "DIST_BACKEND")}
    env["OMP_NUM_THREADS"] = "1"
    inputs, worlds = {}, []
    for name, (kw, model) in CONFIGS.items():
        inputs[name] = _inputs(kw)
        wd = d / name

        def prepare(wd=wd, inp=inputs[name]):
            shutil.rmtree(wd, ignore_errors=True)
            os.makedirs(wd)
            torch.save(inp, wd / "inputs.pt")

        worlds.append(World(lambda ports, model=model, wd=wd: [
            [sys.executable, WORKER, str(r), str(model), str(model), ports[0], str(wd)]
            for r in range(model)], env=env, prepare=prepare))
    try:
        ref = {}
        for name, (_, model) in CONFIGS.items():
            ref[name] = _jax_runs(inputs[name], model)
            ref[name]["one_step"] = _one_process_step(inputs[name])
        for w in worlds:
            w.wait(240)
    finally:
        for w in worlds:
            w.kill()
    ranks = {name: [torch.load(d / name / f"rank{r}_of{model}.pt", weights_only=True)
                    for r in range(model)] for name, (_, model) in CONFIGS.items()}
    return dict(ref=ref, ranks=ranks, inputs=inputs)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_layout_cuts_and_round_trip(runs, name):
    """Which leaves the axis cuts, each rank's heads, and gather_params of
    the shards: the whole tree bit for bit on every rank."""
    kw, model = CONFIGS[name]
    cfg = ControlVARConfig(**kw)
    whole = dict(named_leaves(runs["inputs"][name]["params"]))
    cut = {n for n in whole if leaf_split(n, cfg, model) is not None}
    if name == "model3":
        assert cut == {"blocks/ada_lin/kernel", "blocks/ada_lin/bias"}
    else:
        assert cut == {"blocks/fc1/kernel", "blocks/fc1/bias", "blocks/fc2/kernel",
                       "blocks/ada_lin/kernel", "blocks/ada_lin/bias", "head/kernel",
                       "head/bias"}
    for r, out in enumerate(runs["ranks"][name]):
        assert out["mesh"] == (1, model, 0, r)
        assert out["heads"] == cfg.num_heads  # the attention stays whole
        assert sorted(out["round_trip"]) == sorted(whole)
        for n, t in whole.items():
            assert torch.equal(out["round_trip"][n], t), n


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_joint_ids_equal_jax_bit_for_bit(runs, name):
    ref = runs["ref"][name]
    assert len(ref["joint_ids"]) == len(VQ["patch_nums"])
    for a, b in zip(ref["joint_fh_mesh"], ref["joint_fh"]):  # JAX's mesh run is its own
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    for out in runs["ranks"][name]:
        assert len(out["joint_ids"]) == len(ref["joint_ids"])
        for si, (a, b) in enumerate(zip(out["joint_ids"], ref["joint_ids"])):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f"scale {si}")
        for a, b in zip(out["joint_fh"], ref["joint_fh_mesh"]):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_step_matches_jax_mesh_and_one_process(runs, name):
    """Model rank 0's gathered params after the step (every rank's are
    bit-equal to them: the next test) and each rank's loss and norm."""
    ref = runs["ref"][name]
    want_jax = ref["step_params"]
    want_one, loss_one, norm_one = ref["one_step"]
    params = runs["ranks"][name][0]["step"][0]
    assert sorted(params) == sorted(want_jax) == sorted(want_one)
    for n in params:
        np.testing.assert_allclose(params[n].numpy(), want_jax[n], atol=1e-5, rtol=0, err_msg=n)
        np.testing.assert_allclose(params[n].numpy(), want_one[n].numpy(), atol=2e-6, rtol=0,
                                   err_msg=n)
    for out in runs["ranks"][name]:
        _, _, loss, norm, _ = out["step"]
        np.testing.assert_allclose(loss, ref["step_aux"][0], rtol=1e-5)
        np.testing.assert_allclose(norm, ref["step_aux"][1], rtol=1e-4)
        np.testing.assert_allclose(loss, loss_one, rtol=1e-6)
        np.testing.assert_allclose(norm, norm_one, rtol=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_ranks_hold_equal_whole_leaves_and_params(runs, name):
    outs = runs["ranks"][name]
    first_params, first_whole = outs[0]["step"][:2]
    assert "blocks/qkv_kernel" in first_whole and "pos_1LC" in first_whole
    for out in outs[1:]:
        params, whole = out["step"][:2]
        assert sorted(whole) == sorted(first_whole)
        for n, t in whole.items():
            assert torch.equal(t, first_whole[n]), n
        for n, t in params.items():
            assert torch.equal(t, first_params[n]), n


# ---- use_flash ------------------------------------------------------------------

def _forward_inputs(cfg, seed=2, B=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.num_classes, (B,)), rng.integers(0, 4, (B,)),
            rng.standard_normal((B, cfg.seq_len - cfg.first_l, cfg.cvae)).astype(np.float32))


@pytest.mark.parametrize("name", list(FORWARDS))
def test_forward_without_flash_matches_jax_and_the_flash_path(name):
    kw = FORWARDS[name]
    cfg = ControlVARConfig(**kw)
    params = _params(kw, np.random.default_rng(1))
    labels, ct, x = _forward_inputs(cfg)
    model = ControlVARModel(cfg, device="cpu")
    args = (params, torch.from_numpy(labels), torch.from_numpy(x))
    run = lambda flash: model.forward_train(*args, cond_type=torch.from_numpy(ct), train=False,
                                            compute_dtype=torch.float32,
                                            use_flash=flash).detach().numpy()
    got, flash = run(False), run(True)
    want = np.asarray(JModel(JCfg(**kw)).forward_train(
        to_jax_params(params, cfg), jnp.asarray(labels, jnp.int32), jnp.asarray(x),
        cond_type=jnp.asarray(ct, jnp.int32), train=False, compute_dtype=jnp.float32,
        use_flash=False))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, flash, atol=1e-5, rtol=0)


def test_var_forward_without_flash_matches_jax():
    kw = dict(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 4), vocab_size=64,
              cvae=32, num_classes=8, cond_drop_rate=0.0)
    cfg = VARConfig(**kw)
    model = VARModel(cfg, device="cpu")
    params = model.init_params(3)
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 8, (2,))
    x = rng.standard_normal((2, cfg.seq_len - cfg.first_l, cfg.cvae)).astype(np.float32)
    run = lambda flash: model.forward_train(params, torch.from_numpy(labels),
                                            torch.from_numpy(x), train=False,
                                            compute_dtype=torch.float32,
                                            use_flash=flash).detach().numpy()
    got = run(False)
    want = np.asarray(JVARModel(JVARCfg(**kw)).forward_train(
        to_jax_params(params, cfg), jnp.asarray(labels, jnp.int32), jnp.asarray(x),
        train=False, compute_dtype=jnp.float32, use_flash=False))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, run(True), atol=1e-5, rtol=0)


def test_mha_xla_matches_jax():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 3, 20, 16)).astype(np.float32) for _ in range(3))
    mask = rng.random((20, 20)) < 0.6
    np.fill_diagonal(mask, True)
    got = mha_xla(*(torch.from_numpy(t) for t in (q, k, v)), 0.25, torch.from_numpy(mask))
    want = j_mha_xla(*(jnp.asarray(t) for t in (q, k, v)), 0.25, jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_only_parity_passes_use_flash_false():
    """The main path and the train steps keep the default: a
    `use_flash=False` keyword appears in the port only in eval/parity.py."""
    hits = set()
    for path in (ROOT / "controlvar_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.keyword) and node.arg == "use_flash" and (
                    not isinstance(node.value, ast.Name) or node.value.id != "use_flash"):
                hits.add(path.relative_to(ROOT).as_posix())
    assert hits == {"controlvar_tpu_torch/eval/parity.py"}
