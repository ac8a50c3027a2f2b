"""The port's checkpoint modules against the JAX package's, on the same
trees, on the CPU: the importer and the exporter bit for bit against the
JAX converters (`from_jax_params` of the JAX import; the JAX export of the
same tree), the .pth loader's unwrapping, VAR -> ControlVAR surgery, and
train-state save/restore (`CheckpointIO`), whose resume must continue
training bit for bit.

The trees are the port's inits carried to the JAX layout (`to_jax_params`;
the VQVAE's conv kernels OIHW -> HWIO), and JAX inits of
the options the port's init does not take yet (cos_attn, shared_aln,
type_pos, separator). The widths
are non-square where they can be (word_embed 32 -> 128, qkv 128 -> 384,
fc1 128 -> 512, head 128 -> 64, the VQVAE's 1x1 shortcut convs), so that
a transposed kernel cannot pass as its own shape."""
import dataclasses
import os

import numpy as np
import pytest

import jax
import torch

from controlvar_tpu.ckpt import surgery as jsurgery
from controlvar_tpu.ckpt import torch_export as jexport
from controlvar_tpu.ckpt import torch_import as jimport
from controlvar_tpu.config import ControlVARConfig as JCVCfg
from controlvar_tpu.config import VARConfig as JVARCfg
from controlvar_tpu.config import VQVAEConfig as JVQCfg
from controlvar_tpu.models.control_var import ControlVARModel as JCVModel

from controlvar_tpu_torch.ckpt import surgery, torch_export, torch_import
from controlvar_tpu_torch.ckpt.convert import from_jax_params, to_jax_params
from controlvar_tpu_torch.ckpt.orbax_io import CheckpointIO
from controlvar_tpu_torch.config import ControlVARConfig, OptimConfig, VARConfig, VQVAEConfig
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.var import VARModel
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.train.param_groups import named_leaves
from controlvar_tpu_torch.train.train_step import ControlVARTrainStep, init_train_state

VQ = dict(ch=32, patch_nums=(1, 2, 4), vocab_size=64)
BASE = dict(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 4), vocab_size=64,
            cvae=32, num_classes=8)
CV = dict(BASE, mask_factor=2, multi_cond=True)
ALL_OPTIONS = dict(CV, cos_attn=True, shared_aln=True, type_pos=True, separator=True)


def _vq_to_jax(tree):
    """The port's VQVAE tree as numpy in the JAX layout (OIHW -> HWIO)."""
    if isinstance(tree, dict):
        return {k: (v.numpy().transpose(2, 3, 1, 0) if k == "kernel" else _vq_to_jax(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_vq_to_jax(v) for v in tree]
    return tree.numpy()


@pytest.fixture(scope="module")
def models():
    """name -> (kind, port config, JAX config, numpy tree in the JAX layout)."""
    vq = VQVAEConfig(**VQ)
    out = {"vqvae": ("vqvae", vq, JVQCfg(**VQ),
                     _vq_to_jax(VQVAE(vq, device="cpu").init_params(0)))}
    cfg = VARConfig(**BASE)
    out["var"] = ("var", cfg, JVARCfg(**BASE),
                  to_jax_params(VARModel(cfg, device="cpu").init_params(1), cfg))
    cfg = ControlVARConfig(**CV)
    out["control_var"] = ("control_var", cfg, JCVCfg(**CV),
                          to_jax_params(ControlVARModel(cfg, device="cpu").init_params(2), cfg))
    jp = JCVModel(JCVCfg(**ALL_OPTIONS)).init_params(jax.random.key(3))
    out["control_var_all_options"] = ("control_var", ControlVARConfig(**ALL_OPTIONS),
                                      JCVCfg(**ALL_OPTIONS),
                                      jax.tree_util.tree_map(np.asarray, jp))
    # the VAR branches of the all-options tree: cos_attn's scale_mul,
    # shared_aln's ada_gss and shared_ada_lin
    var_opts = dict(BASE, cos_attn=True, shared_aln=True)
    tree = {k: v for k, v in out["control_var_all_options"][3].items()
            if k not in ("cond_embed", "type_embed", "special_embed")}
    tree = dict(tree, pos_1LC=out["var"][3]["pos_1LC"], head=out["var"][3]["head"])
    out["var_cos_attn_shared_aln"] = ("var", VARConfig(**var_opts), JVARCfg(**var_opts), tree)
    sep = dict(CV, separator=True)  # a fresh tree for surgery into the separator layout
    out["control_var_separator"] = ("control_var", ControlVARConfig(**sep), JCVCfg(**sep),
                                    jax.tree_util.tree_map(np.asarray, JCVModel(
                                        JCVCfg(**sep)).init_params(jax.random.key(4))))
    return out


CONVERT = {"vqvae": ("convert_vqvae_state_dict", "export_vqvae_state_dict"),
           "var": ("convert_var_state_dict", "export_var_state_dict"),
           "control_var": ("convert_control_var_state_dict", "export_control_var_state_dict")}
NAMES = ["vqvae", "var", "var_cos_attn_shared_aln", "control_var", "control_var_all_options"]


def _assert_trees_equal(got, want, path=""):
    """Same structure, and every leaf an equal fp32 CPU tensor, bit for bit."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(set(got) ^ set(want)))
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}/{i}")
    else:
        assert got.dtype == torch.float32 and got.is_contiguous(), path
        assert got.shape == want.shape, (path, got.shape, want.shape)
        assert torch.equal(got, want), path


def _port_tree(models, name):
    kind, cfg, _, tree = models[name]
    return from_jax_params(tree, cfg, device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_import_equals_from_jax_params_of_the_jax_converter(models, name):
    kind, cfg, jcfg, tree = models[name]
    conv, export = CONVERT[kind]
    sd = getattr(jexport, export)(tree, jcfg)
    want = from_jax_params(getattr(jimport, conv)(sd, jcfg), cfg, device="cpu")
    _assert_trees_equal(getattr(torch_import, conv)(sd, cfg, device="cpu"), want)
    # a state dict of torch tensors, as load_torch_state_dict returns it
    sd_t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    _assert_trees_equal(getattr(torch_import, conv)(sd_t, cfg, device="cpu"), want)


@pytest.mark.parametrize("name", NAMES)
def test_export_equals_the_jax_export(models, name):
    kind, cfg, jcfg, tree = models[name]
    _, export = CONVERT[kind]
    kw = {}
    if kind == "vqvae":  # the usage EMA state, as the tokenizer trainer keeps it
        hits = np.random.default_rng(0).random((3, 64)).astype(np.float32)
        kw = dict(usage={"ema_hits": hits})
    want = getattr(jexport, export)(tree, jcfg, **kw)
    got = getattr(torch_export, export)(_port_tree(models, name), cfg, **kw)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == torch.float32 and g.device.type == "cpu" and g.is_contiguous(), k
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


@pytest.mark.parametrize("name", ["vqvae", "control_var_all_options"])
def test_pth_round_trip(models, name, tmp_path):
    """export -> save_torch_checkpoint -> load_torch_state_dict -> convert
    gives the tree back, and the file is shaped as the reference trainer's."""
    kind, cfg, _, _ = models[name]
    conv, export = CONVERT[kind]
    params = _port_tree(models, name)
    path = str(tmp_path / "ckpt.pth")
    torch_export.save_torch_checkpoint(path, getattr(torch_export, export)(params, cfg),
                                       step=7, epoch=2)
    raw = torch.load(path, weights_only=True)
    assert sorted(raw) == ["epoch", "model_state_dict", "step"]
    assert (raw["epoch"], raw["step"]) == (2, 7)
    back = getattr(torch_import, conv)(torch_import.load_torch_state_dict(path), cfg,
                                       device="cpu")
    _assert_trees_equal(back, params)


@pytest.mark.parametrize("wrap", ["plain", "ddp", "trainer", "state_dict", "trainer_ddp"])
def test_load_torch_state_dict_strips_the_wrappers(wrap, tmp_path):
    import argparse

    sd = {"word_embed.weight": torch.randn(128, 8), "pos_start": torch.randn(1, 1, 128)}
    ddp = {f"module.{k}": v for k, v in sd.items()}
    obj = {"plain": sd, "ddp": ddp, "state_dict": {"state_dict": sd},
           # a trainer checkpoint pickles more than tensors: its args too, which
           # only weights_only=False loads
           "trainer": {"model_state_dict": sd, "epoch": 3,
                       "args": argparse.Namespace(lr=1e-4)},
           "trainer_ddp": {"model_state_dict": ddp, "optimizer": {"lr": 1e-4}}}[wrap]
    path = str(tmp_path / "ckpt.pth")
    torch.save(obj, path)
    out = torch_import.load_torch_state_dict(path)
    assert sorted(out) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(out[k], v)


def _surgery_inputs(models, separator):
    """(config, VAR params, fresh ControlVAR params, the fresh numpy tree)."""
    _, cfg, _, fresh_tree = models["control_var_separator" if separator else "control_var"]
    return cfg, _port_tree(models, "var"), from_jax_params(fresh_tree, cfg, device="cpu"), \
        fresh_tree


def test_surgery_concat_is_exact_and_shares_nothing(models):
    cfg, var, fresh, fresh_tree = _surgery_inputs(models, False)
    var_before = {k: v.clone() for k, v in named_leaves(var)}
    out = surgery.var_to_control_var(var, fresh, cfg, mode="concat")
    want = jsurgery.var_to_control_var(models["var"][3], fresh_tree, JCVCfg(**CV),
                                       mode="concat")
    _assert_trees_equal(out, from_jax_params(jax.tree_util.tree_map(np.asarray, want), cfg,
                                             device="cpu"))
    pos = var["pos_1LC"]
    assert torch.equal(out["pos_1LC"], torch.cat([pos, pos], dim=1))
    assert torch.equal(out["pos_start"], fresh["pos_start"])
    for name, leaf in named_leaves(out):  # training the result leaves the inputs alone
        leaf.add_(1.0)
    for name, leaf in named_leaves(var):
        assert torch.equal(leaf, var_before[name]), name


@pytest.mark.parametrize("separator,mpos", [(False, False), (True, False), (True, True)])
def test_surgery_interpos_transfers_every_slot(models, separator, mpos):
    """Transferred slots equal the JAX surgery's bit for bit; fresh slots
    (separator positions, separator head columns) are drawn inside +-2
    standard deviations of their init and differ from JAX's draws."""
    cfg_kw = dict(CV, separator=separator)
    cfg, var, fresh, fresh_tree = _surgery_inputs(models, separator)
    out = surgery.var_to_control_var(var, fresh, cfg, mode="interpos", mpos=mpos, seed=1)
    want = jax.tree_util.tree_map(np.asarray, jsurgery.var_to_control_var(
        models["var"][3], fresh_tree, JCVCfg(**cfg_kw), mode="interpos", mpos=mpos))
    C = cfg.embed_dim
    std = np.sqrt(1.0 / C / 3.0)
    got_pos, want_pos = out["pos_1LC"][0].numpy(), want["pos_1LC"][0]
    assert got_pos.shape == (cfg.seq_len, C)
    fresh_rows, off = [], 0
    for i, pn in enumerate(cfg.patch_nums):
        l, sp = pn * pn, (1 if (i and separator) else 0)
        fresh_rows += [off + l] * sp + [off + 2 * l + sp] * sp
        off += 2 * (l + sp)
    kept = np.setdiff1d(np.arange(cfg.seq_len), fresh_rows)
    np.testing.assert_array_equal(got_pos[kept], want_pos[kept])
    V = cfg.vocab_size
    np.testing.assert_array_equal(out["head"]["kernel"][:, :V].numpy(),
                                  want["head"]["kernel"][:, :V])
    np.testing.assert_array_equal(out["head"]["bias"].numpy(), want["head"]["bias"])
    assert out["head"]["kernel"].shape == (C, cfg.head_vocab)
    for name in ("blocks", "word_embed", "class_emb", "lvl_embed", "head_nm"):
        _assert_trees_equal(out[name], var[name])
    if separator:
        assert len(fresh_rows) == 2 * (len(cfg.patch_nums) - 1)
        new_pos = got_pos[fresh_rows]
        new_head = out["head"]["kernel"][:, V:].numpy()
        for new, s in ((new_pos, std), (new_head, 0.02 * std)):
            assert np.abs(new).max() <= 2 * s and new.std() > 0.5 * s
        assert not np.array_equal(new_pos, want_pos[fresh_rows])
        again = surgery.var_to_control_var(var, fresh, cfg, mode="interpos", mpos=mpos, seed=1)
        assert torch.equal(again["pos_1LC"], out["pos_1LC"])  # the seed fixes the draws


def _token_batch(seed, B=2):
    g = torch.Generator().manual_seed(seed)
    ids = lambda: [torch.randint(0, 64, (B, p * p), generator=g) for p in BASE["patch_nums"]]
    return {"ctrl_ids": ids(), "img_ids": ids(), "cls": torch.randint(0, 8, (B,), generator=g),
            "type": torch.randint(0, 4, (B,), generator=g)}


def _stepper():
    cfg = ControlVARConfig(**CV, cond_drop_rate=0.0)
    return (ControlVARTrainStep(ControlVARModel(cfg, device="cpu"),
                                VQVAE(VQVAEConfig(**VQ), device="cpu"),
                                OptimConfig(base_lr=1e-2, total_batch_size=512), max_steps=50,
                                warmup_steps=2, device="cpu"), cfg)


def _snapshot(state):
    params = {k: v.detach().clone() for k, v in named_leaves(state.params)}
    moments = {(i, k): v.clone() for i, s in state.optimizer.state_dict()["state"].items()
               for k, v in s.items()}
    return params, moments, state.step


def test_checkpoint_resume_continues_training_bit_for_bit(models, tmp_path):
    """Save at step 1, then two more steps; against a fresh state (other
    weights) restored from the save, then the same two steps: params, Adam
    moments and the step count equal bit for bit."""
    stepper, cfg = _stepper()
    model, vp = stepper.model, stepper.vqvae.init_params(0)
    state = init_train_state(model.init_params(1), stepper.optim)
    stepper.step(state, vp, _token_batch(0), from_tokens=True)
    io = CheckpointIO(str(tmp_path / "ckpts"))
    io.save(state.step, state, metadata={"epoch": 0})
    for i in (1, 2):
        stepper.step(state, vp, _token_batch(i), from_tokens=True)
    other = init_train_state(model.init_params(5), stepper.optim)
    restored, meta = io.restore(other)
    assert restored is other and other.step == 1 and meta == {"epoch": 0}
    for i in (1, 2):
        stepper.step(other, vp, _token_batch(i), from_tokens=True)
    (p_a, m_a, s_a), (p_b, m_b, s_b) = _snapshot(state), _snapshot(other)
    assert s_a == s_b == 3 and sorted(m_a) == sorted(m_b) and m_a
    for name in p_a:
        assert torch.equal(p_a[name], p_b[name]), name
    for key in m_a:
        assert torch.equal(m_a[key], m_b[key]), key


def test_checkpoint_bookkeeping(tmp_path, monkeypatch):
    """max_to_keep pruning, latest_step, metadata, restore_raw, an empty
    directory, a tree of another shape, and a write that did not finish."""
    stepper, cfg = _stepper()
    state = init_train_state(stepper.model.init_params(1), stepper.optim)
    io = CheckpointIO(str(tmp_path), max_to_keep=2)
    assert io.latest_step() is None and io.restore(state) == (None, None)
    assert io.restore_raw() == (None, None)
    for step in (1, 2, 3, 5):
        state.step = step
        io.save(step, state, metadata={"epoch": step, "tag": "a"})
    assert sorted(os.listdir(tmp_path)) == ["3.pt", "5.pt"] and io.latest_step() == 5
    raw, meta = io.restore_raw(3)
    assert meta == {"epoch": 3, "tag": "a"} and raw["step"] == 3
    for name, leaf in named_leaves(state.params):
        np.testing.assert_array_equal(dict(named_leaves(raw["params"]))[name],
                                      leaf.detach().numpy())
    assert isinstance(raw["optimizer"]["param_groups"], list)
    # a write that fails part-way leaves no step behind
    real_save = torch.save

    def broken_save(obj, path):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken_save)
    with pytest.raises(OSError):
        io.save(9, state)
    monkeypatch.setattr(torch, "save", real_save)
    assert io.latest_step() == 5 and (tmp_path / "9.pt.tmp").exists()
    bigger = ControlVARModel(dataclasses.replace(cfg, depth=3), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        io.restore(init_train_state(bigger.init_params(0), stepper.optim))
