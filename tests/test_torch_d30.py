"""ControlVAR-d30's width against the JAX package, fp32 on the CPU.

d30 is the one released config with cos_attn (q and k L2-normalised, q
times exp(min(scale_mul, log 100)) per head, attention at scale 1) and
with 30 heads (C 1920, head dim 64). The model here is each package's
`control_var_config_from_depth(30, multi_cond=True)` cut to depth 2 and
patch_nums (1, 2, 4): the full width, 30 heads and V 4096, about 150 M
parameters. Every scale_mul is drawn uniform in [0, log 200], so that some
heads clamp at log 100 and scores reach +-100, and the AdaLN gates are
raised (attention by 10, the FFN by 1: at init the gates leave attention
out of the outputs). The weights are the port's init carried to the JAX
layout (`to_jax_params`) and back (`from_jax_params`); JAX's eager init
of 150 M parameters would take most of this file's time.

Tolerances, each as the narrower file states it: teacher-forced logits
within 1e-4 absolute (tests/test_torch_transformer.py; fp32 reassociation
over width 1920, logits of ~1); greedy (top_k=1) ids bit for bit at every
scale and the canvases within 1e-4 (tests/test_torch_stepwise.py); one
fp32 train step at tests/test_torch_train_step.py's limits: the loss 1e-5
and grad_norm 1e-4 relative, gradients within 1e-4 of each leaf's largest
(JAX's read from its first Adam moment, mu = (1 - b1) g), params within
1e-5 absolute. AdamW's first step moves a param by lr g / (|g| + eps),
about lr sign(g): where |g| lies within the gradient tolerance of 0 the
two packages' fp32 noise can flip that sign, so those params are held
within lr + 1e-5, and only they.

Also here: the d30 recipe (configs/train_imagenetc_d30.yaml) through both
command lines against the flags that chip_smoke.py's d30 phase passes, and
the JAX package's VAR -> ControlVAR surgery at cos_attn, whose grafted
blocks lack scale_mul (ROADMAP queue 3)."""
import dataclasses
import math
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import controlvar_tpu.eval.stepwise as jax_stepwise
from controlvar_tpu import config as jconfig
from controlvar_tpu.ckpt.surgery import var_to_control_var as j_var_to_control_var
from controlvar_tpu.cli import main as jcli
from controlvar_tpu.config import VQVAEConfig as JVQ
from controlvar_tpu.models.control_var import ControlVARModel as JModel
from controlvar_tpu.models.vqvae import VQVAE as JVQVAE
from controlvar_tpu.train.train_step import ControlVARTrainStep as JTrainStep
from controlvar_tpu.train.train_step import init_train_state as j_init_train_state

import controlvar_tpu_torch.eval.stepwise as torch_stepwise
from controlvar_tpu_torch import config as tconfig
from controlvar_tpu_torch.ckpt.convert import from_jax_params, to_jax_params
from controlvar_tpu_torch.ckpt.surgery import var_to_control_var
from controlvar_tpu_torch.cli import main as tcli
from controlvar_tpu_torch.config import VQVAEConfig
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.var import VARModel
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.train.param_groups import named_leaves
from controlvar_tpu_torch.train.train_step import ControlVARTrainStep, init_train_state

from tests.torch_fixtures import one_torch_thread, vq_to_jax  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PNS = (1, 2, 4)
CUT = dict(depth=2, patch_nums=PNS)
VQ = dict(ch=32, patch_nums=PNS)                # vocab 4096, z 32: d30's tokenizer widths
MAX_COS_SCALE = math.log(100.0)
B = 2


def _d30(cfgmod, **kw):
    return cfgmod.control_var_config_from_depth(30, multi_cond=True, **kw)


def _cut(cfgmod, **kw):
    return dataclasses.replace(_d30(cfgmod), **CUT, **kw)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _leaf_dict(tree):
    """{path: leaf} of a nested tree, path names as the port's named_leaves."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in path): leaf
            for path, leaf in flat}


@pytest.fixture(scope="module")
def d30():
    """The cut d30 in both packages on the same weights: random scale_mul
    (some heads clamped), the gates raised; and the ch-32 VQVAE."""
    cfg, jcfg = _cut(tconfig), _cut(jconfig)
    tree = to_jax_params(ControlVARModel(cfg, device="cpu").init_params(0), cfg)
    b = tree["blocks"]
    b["scale_mul"] = np.random.default_rng(3).uniform(
        0.0, math.log(200.0), b["scale_mul"].shape).astype(np.float32)
    clamped = b["scale_mul"] > MAX_COS_SCALE
    assert clamped.any() and not clamped.all()
    C = cfg.embed_dim
    b["ada_lin"]["bias"] = b["ada_lin"]["bias"].copy()
    b["ada_lin"]["bias"][:, :C] += 10.0
    b["ada_lin"]["bias"][:, C: 2 * C] += 1.0
    tv = VQVAE(VQVAEConfig(**VQ), device="cpu")
    tvp = tv.init_params(0)
    return dict(cfg=cfg, jcfg=jcfg, tree=tree, jp=_jnp(tree),
                tp=from_jax_params(tree, cfg, device="cpu"), clamped=clamped,
                jv=JVQVAE(JVQ(**VQ)), jvp=_jnp(vq_to_jax(tvp)), tv=tv, tvp=tvp)


# ---- the config ----------------------------------------------------------------

@pytest.mark.parametrize("override", [{}, dict(drop_path_rate=0.1)], ids=["law", "yaml"])
def test_d30_config_equals_jax_field_for_field(override):
    got, want = _d30(tconfig, **override), _d30(jconfig, **override)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.cos_attn, got.num_heads, got.embed_dim, got.head_dim) == (True, 30, 1920, 64)
    assert got.drop_path_rate == (0.1 if override else 0.1 * 30 / 24)
    assert (got.seq_len, got.vocab_size, got.num_scales) == (1360, 4096, 10)
    assert not tconfig.control_var_config_from_depth(24, multi_cond=True).cos_attn


def test_cut_d30_width_and_leaves(d30):
    """The cut model keeps d30's width: 30 heads of 64, scale_mul (2, 30)."""
    n = sum(leaf.numel() for _, leaf in named_leaves(d30["tp"]))
    assert 1.4e8 < n < 1.6e8
    assert d30["tp"]["blocks"]["scale_mul"].shape == (2, 30)
    assert d30["tp"]["blocks"]["qkv_kernel"].shape == (2, 1920, 5760)


# ---- the teacher-forced forward ------------------------------------------------

def test_forward_train_logits_match_jax(d30):
    cfg = d30["cfg"]
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (B, cfg.seq_len - cfg.first_l, cfg.cvae)).astype(np.float32)
    labels, ct = np.array([1, 977]), np.array([0, 3])
    want = JModel(d30["jcfg"]).forward_train(
        d30["jp"], jnp.asarray(labels), jnp.asarray(x), jnp.asarray(ct), train=False,
        compute_dtype=jnp.float32)
    got = ControlVARModel(cfg, device="cpu").forward_train(
        d30["tp"], torch.from_numpy(labels), torch.from_numpy(x), torch.from_numpy(ct),
        train=False, compute_dtype=torch.float32)
    assert got.shape == (B, cfg.seq_len, 4096)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)


# ---- the samplers, greedy ------------------------------------------------------

def _recorder(module, monkeypatch, traced=False):
    """Record every draw of a sampler module; a traced (jitted) draw is
    recorded by an ordered host callback when it runs."""
    calls = []
    orig = module.sample_top_k_top_p

    def spy(*args, **kw):
        out = orig(*args, **kw)
        if traced:
            jax.debug.callback(lambda x: calls.append(np.asarray(x)), out, ordered=True)
        else:
            calls.append(out.numpy())
        return out

    monkeypatch.setattr(module, "sample_top_k_top_p", spy)
    return calls


@pytest.mark.parametrize("sampler", ["cond", "joint"])
def test_greedy_samplers_match_jax(d30, monkeypatch, sampler):
    """StepwiseCondSampler (force control, 4-way CFG, random forced ids) and
    StepwiseJointSampler (2-way CFG 4.0), both over the stacked cache: the
    ids of every draw bit for bit, the outputs within 1e-4."""
    jax_ids = _recorder(jax_stepwise, monkeypatch, traced=True)
    torch_ids = _recorder(torch_stepwise, monkeypatch)
    jm, tm = JModel(d30["jcfg"]), ControlVARModel(d30["cfg"], device="cpu")
    labels, ct = np.array([3, 977]), np.array([1, 2])
    rng = np.random.default_rng(4)
    forced = [rng.integers(0, 4096, (B, pn * pn)) for pn in PNS]
    t = torch.from_numpy
    if sampler == "cond":
        kw = dict(cfg_scales=(4.0, 4.0, 4.0), top_k=1, top_p=0.0, force="control",
                  decode="image")
        js = jax_stepwise.StepwiseCondSampler(jm, d30["jv"], **kw)
        ts = torch_stepwise.StepwiseCondSampler(tm, d30["tv"], device="cpu",
                                                compute_dtype=torch.float32, **kw)
        js.compute_dtype = jnp.float32
        jout = js(d30["jp"], d30["jvp"], jnp.asarray(labels), jnp.asarray(ct),
                  jax.random.key(9), [jnp.asarray(f, jnp.int32) for f in forced])
        tout = ts(d30["tp"], d30["tvp"], t(labels), t(ct), torch.Generator().manual_seed(9),
                  [t(f) for f in forced])
    else:
        kw = dict(cfg_scale=4.0, top_k=1, top_p=0.0)
        js = jax_stepwise.StepwiseJointSampler(jm, d30["jv"], groups=(tuple(range(len(PNS))),),
                                               **kw)
        ts = torch_stepwise.StepwiseJointSampler(tm, d30["tv"], device="cpu",
                                                 compute_dtype=torch.float32, **kw)
        js.compute_dtype = jnp.float32
        jout = js(d30["jp"], d30["jvp"], jnp.asarray(labels), jnp.asarray(ct),
                  jax.random.key(7), decode_img=False)
        tout = ts(d30["tp"], d30["tvp"], t(labels), t(ct), torch.Generator().manual_seed(7),
                  decode_img=False)
    jax.block_until_ready(jout)
    assert len(jax_ids) == len(torch_ids) == len(PNS)
    for si, (a, b) in enumerate(zip(jax_ids, torch_ids)):
        np.testing.assert_array_equal(a, b, err_msg=f"draw {si}")
    for a, b in zip(jout, tout):
        assert tuple(b.shape) == tuple(np.shape(a))
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4, rtol=0)


# ---- one train step --------------------------------------------------------------

class _JFp32Model(JModel):
    """The JAX model with an fp32 residual stream (its train step always
    takes the default bf16)."""

    def forward_train(self, *args, **kwargs):
        return super().forward_train(*args, compute_dtype=jnp.float32, **kwargs)


class _Fp32Step(ControlVARTrainStep):
    tokenize_dtype = torch.float32
    compute_dtype = torch.float32


def test_train_step_matches_jax(d30):
    """One pre-tokenized fp32 step with d30's optimizer recipe at a peak lr
    of 1e-2 (5e-5 at the warm-up's first step; cond drop and drop path off:
    the two packages' draws differ). 54 of the qkv and proj kernels'
    elements have |g| ~2e-8, where the sign flip moves them by ~4e-5. The
    clipped heads' scale_mul gets a zero gradient in both packages, the
    others a non-zero one."""
    no_drop = dict(drop_path_rate=0.0, cond_drop_rate=0.0)
    jcfg, cfg = _cut(jconfig, **no_drop), _cut(tconfig, **no_drop)
    optim = dict(base_lr=1e-2, total_batch_size=512, weight_decay=0.08,
                 weight_decay_end=0.08, schedule="lin0")
    rng = np.random.default_rng(10)
    ids = lambda: [rng.integers(0, 4096, (B, p * p)) for p in PNS]
    batch = dict(ctrl_ids=ids(), img_ids=ids(), cls=rng.integers(0, 1000, (B,)),
                 type=rng.integers(0, 4, (B,)))

    jstep = JTrainStep(_JFp32Model(jcfg), d30["jv"], jconfig.OptimConfig(**optim),
                       max_steps=100, warmup_steps=1)
    jstate, tx = j_init_train_state(d30["jp"], jconfig.OptimConfig(**optim))
    jbatch = jax.tree_util.tree_map(lambda a: jnp.asarray(a.astype(np.int32)), batch)
    jstate, ja = jax.jit(lambda st, vp, b, k: jstep.step(tx, st, vp, b, k, from_tokens=True))(
        jstate, d30["jvp"], jbatch, jax.random.key(0))
    j_grads = {k: np.asarray(v) / (1 - 0.9)
               for k, v in _leaf_dict(jstate.opt_state.inner_state[1].mu).items()}
    j_params = {k: np.asarray(v) for k, v in _leaf_dict(jstate.params).items()}
    del jstate

    tstep = _Fp32Step(ControlVARModel(cfg, device="cpu"), d30["tv"],
                      tconfig.OptimConfig(**optim), max_steps=100, warmup_steps=1,
                      device="cpu")
    tstate = init_train_state(from_jax_params(d30["tree"], cfg, device="cpu"),
                              tconfig.OptimConfig(**optim))
    tstate, ta = tstep.step(tstate, d30["tvp"], jax.tree_util.tree_map(torch.from_numpy, batch),
                            torch.Generator().manual_seed(0), from_tokens=True)
    np.testing.assert_allclose(float(ta["loss"]), float(ja["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(ta["grad_norm"]), float(ja["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(ta["lr"], float(ja["lr"]), rtol=1e-6)
    np.testing.assert_allclose(ta["wd"], float(ja["wd"]), rtol=1e-6)
    assert float(ta["grad_norm"]) > 2.0  # the clip is active: both clip the same way

    t_leaves = dict(named_leaves(tstate.params))
    assert sorted(t_leaves) == sorted(j_grads)
    lr = float(ja["lr"])
    for name, leaf in t_leaves.items():
        gw, gt = j_grads[name], leaf.grad.numpy()
        tol = 1e-4 * np.abs(gw).max() + 1e-12
        np.testing.assert_allclose(gt, gw, rtol=0, atol=tol, err_msg=name)
        p_got, p_want = leaf.detach().numpy(), j_params[name]
        clear = np.abs(gw) > 2 * tol  # |g| clear of the noise: the same sign
        np.testing.assert_allclose(p_got[clear], p_want[clear], rtol=0, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(p_got, p_want, rtol=0, atol=lr + 1e-5, err_msg=name)

    clamped = d30["clamped"]
    for g in (j_grads["blocks/scale_mul"], t_leaves["blocks/scale_mul"].grad.numpy()):
        assert (g[clamped] == 0).all()
        assert (g[~clamped] != 0).all()


# ---- the d30 recipe --------------------------------------------------------------

class _Built(Exception):
    pass


def _trainer_args(cli, argv, monkeypatch, module):
    """(model config, OptimConfig) that `cli.main(argv)`'s train command
    hands its Trainer: the Trainer, the tokenizer load and the dataset are
    stubbed, so nothing is built or run."""
    seen = {}

    def trainer(cfg, vq_cfg, optim, *args, **kwargs):
        seen.update(cfg=cfg, optim=optim)
        raise _Built

    monkeypatch.setattr(cli, "_load_vqvae", lambda args, vq_cfg: (None, None))
    monkeypatch.setattr(f"{module}.train.trainer.Trainer", trainer)
    monkeypatch.setattr(f"{module}.data.build.create_dataset", lambda *a, **k: None)
    monkeypatch.setattr(f"{module}.data.build.Loader", lambda *a, **k: None)
    with pytest.raises(_Built):
        cli.main(argv)
    return seen["cfg"], seen["optim"]


def test_d30_recipe_yaml_equals_the_flags_of_the_chip_run(monkeypatch):
    """configs/train_imagenetc_d30.yaml through each CLI's own --config
    merge gives one model config and OptimConfig, and the flags that
    chip_smoke.py's d30 phase passes (the card's machine has no pyyaml)
    give the same, as does the phase's own d30_recipe()."""
    pytest.importorskip("yaml")
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke

    path = os.path.join(ROOT, "configs", "train_imagenetc_d30.yaml")
    jc, jo = _trainer_args(jcli, ["train", "--config", path], monkeypatch, "controlvar_tpu")
    tc, to = _trainer_args(tcli, ["train", "--config", path, "--device", "cpu"], monkeypatch,
                           "controlvar_tpu_torch")
    fc, fo = _trainer_args(tcli, ["train", *chip_smoke.D30_TRAIN_FLAGS, "--device", "cpu"],
                           monkeypatch, "controlvar_tpu_torch")
    rc, ro = chip_smoke.d30_recipe()
    want_cfg, want_optim = dataclasses.asdict(jc), dataclasses.asdict(jo)
    for cfg, optim in ((tc, to), (fc, fo), (rc, ro)):
        assert dataclasses.asdict(cfg) == want_cfg
        assert dataclasses.asdict(optim) == want_optim
    assert jc.cos_attn and jc.drop_path_rate == 0.1 and jc.depth == 30 and jc.multi_cond
    assert (jo.base_lr, jo.weight_decay, jo.wd_end, jo.schedule, jo.total_batch_size) == (
        4e-5, 0.08, 0.08, "lin0", 8)


# ---- surgery at cos_attn ---------------------------------------------------------

TINY = dict(depth=2, embed_dim=128, num_heads=2, patch_nums=PNS, vocab_size=64, cvae=32,
            num_classes=8)


def test_surgery_at_cos_attn_drops_scale_mul_in_jax_and_the_port_names_it():
    """The JAX surgery copies `blocks` from the VAR tree, and its CLI builds
    that tree with var_config_from_depth, which never sets cos_attn: at d30
    the grafted ControlVAR tree has no scale_mul and the first forward
    fails on it. The port raises a ValueError naming the leaf at the
    surgery. From a VAR tree that has scale_mul both graft the same keys."""
    cfg = tconfig.ControlVARConfig(**TINY, mask_factor=2, cos_attn=True)
    jcfg = jconfig.ControlVARConfig(**TINY, mask_factor=2, cos_attn=True)
    fresh = ControlVARModel(cfg, device="cpu").init_params(0)
    j_fresh = _jnp(to_jax_params(fresh, cfg))
    assert "scale_mul" in fresh["blocks"]
    for var_cos in (False, True):
        vcfg = tconfig.VARConfig(**TINY, cos_attn=var_cos)
        var = VARModel(vcfg, device="cpu").init_params(1)
        j_out = j_var_to_control_var(_jnp(to_jax_params(var, vcfg)), j_fresh, jcfg)
        x = jnp.zeros((1, jcfg.seq_len - jcfg.first_l, 32), jnp.float32)
        run = lambda p: JModel(jcfg).forward_train(p, jnp.array([1]), x, None, train=False)
        if var_cos:
            got = var_to_control_var(var, fresh, cfg)
            assert sorted(_leaf_dict(to_jax_params(got, cfg))) == sorted(_leaf_dict(j_out))
            assert run(j_out).shape == (1, jcfg.seq_len, 64)
        else:
            assert "scale_mul" not in j_out["blocks"]
            with pytest.raises(KeyError, match="scale_mul"):
                run(j_out)
            with pytest.raises(ValueError, match="blocks/scale_mul"):
                var_to_control_var(var, fresh, cfg)
