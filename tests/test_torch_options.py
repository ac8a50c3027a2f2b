"""The model options of the port (separator, type_pos, shared_aln,
bidirectional) and the model-level conditional sampler, against the JAX
package.

Both sides run on the CPU in fp32 on the same weights: the JAX init of
each option's model, carried over by `ckpt/convert.py:from_jax_params`
(the port's tokenizer init goes the other way, as in
tests/test_torch_var.py). The AdaLN gates are raised so that attention
moves every output. Tolerances: masks and index tables bit for bit;
teacher-forced logits within 1e-5 absolute (fp32 reassociation over two
layers of width 128, logits of ~0.3); blocks outputs within 1e-5 and their
gradients within 1e-4 of each leaf's largest; greedy (top_k=1) ids bit for
bit at every scale and the f_hat canvases within 1e-4, as
tests/test_torch_joint.py holds them."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import controlvar_tpu.eval.stepwise as jax_stepwise
import controlvar_tpu.models.control_var as jax_cv
from controlvar_tpu.config import ControlVARConfig as JCfg, VARConfig as JVCfg
from controlvar_tpu.config import VQVAEConfig as JVQ
from controlvar_tpu.models import masks as jmasks
from controlvar_tpu.models import transformer as jtfm
from controlvar_tpu.models.control_var import ControlVARModel as JModel
from controlvar_tpu.models.var import VARModel as JVAR
from controlvar_tpu.models.vqvae import VQVAE as JVQVAE

import controlvar_tpu_torch.eval.stepwise as torch_stepwise
import controlvar_tpu_torch.models.control_var as torch_cv
from controlvar_tpu_torch.ckpt.convert import from_jax_params, to_jax_params
from controlvar_tpu_torch.config import ControlVARConfig, VARConfig, VQVAEConfig
from controlvar_tpu_torch.models import masks, transformer as tfm
from controlvar_tpu_torch.models.control_var import ControlVARModel, separator_mapping
from controlvar_tpu_torch.models.var import VARModel
from controlvar_tpu_torch.models.vqvae import VQVAE

from tests.torch_fixtures import one_torch_thread, vq_to_jax  # noqa: F401

PNS = (1, 2, 3, 4)
TINY_VQ = dict(ch=32, patch_nums=PNS, vocab_size=64)
BASE = dict(depth=2, embed_dim=128, num_heads=2, patch_nums=PNS, vocab_size=64, cvae=32,
            num_classes=8, mask_factor=2, cond_drop_rate=0.0)
SEP_TP = dict(BASE, multi_cond=True, separator=True, type_pos=True)
OPTIONS = {
    "separator": dict(BASE, multi_cond=True, separator=True),
    "type_pos": dict(BASE, multi_cond=True, type_pos=True),
    "separator+type_pos": SEP_TP,
    "shared_aln": dict(BASE, multi_cond=True, shared_aln=True),
    "bidirectional": dict(BASE, bidirectional=True),
    "all": dict(SEP_TP, shared_aln=True, bidirectional=True),
}


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _raise_gates(tree):
    """Raise the attention gate by 10 and the FFN gate by 1 (at init they
    are 1e-3 of the rest, which leaves attention out of the outputs); give
    shared_ada_lin a bias (zero at init, where a wrong bias goes unseen)."""
    if "shared_ada_lin" in tree:
        lin = tree["shared_ada_lin"]
        lin["bias"] = lin["bias"] + np.random.default_rng(9).normal(
            0, 0.1, lin["bias"].shape).astype(np.float32)
    b = tree["blocks"]
    if "ada_gss" in b:
        b["ada_gss"] = b["ada_gss"].copy()
        b["ada_gss"][:, 0] += 10.0
        b["ada_gss"][:, 1] += 1.0
    else:
        C = b["ada_lin"]["bias"].shape[1] // 6
        b["ada_lin"] = dict(b["ada_lin"], bias=b["ada_lin"]["bias"].copy())
        b["ada_lin"]["bias"][:, :C] += 10.0
        b["ada_lin"]["bias"][:, C: 2 * C] += 1.0
    return tree


_MODELS = {}


def _models(kw, var=False):
    """(JAX model, port model, JAX params, port params) of one config: the
    JAX init with raised gates, carried to the port; built once per config."""
    key = (tuple(sorted(kw.items())), var)
    if key not in _MODELS:
        jcfg, cfg = (JVCfg(**kw), VARConfig(**kw)) if var else (JCfg(**kw), ControlVARConfig(**kw))
        jm = JVAR(jcfg) if var else JModel(jcfg)
        tree = _raise_gates(_tree(jax.jit(jm.init_params)(jax.random.key(1))))
        tm = VARModel(cfg, device="cpu") if var else ControlVARModel(cfg, device="cpu")
        _MODELS[key] = (jm, tm, jax.tree_util.tree_map(jnp.asarray, tree),
                        from_jax_params(tree, cfg, device="cpu"))
    return _MODELS[key]


@pytest.fixture(scope="module")
def vq():
    tv = VQVAE(VQVAEConfig(**TINY_VQ), device="cpu")
    tvp = tv.init_params(0)
    return dict(jv=JVQVAE(JVQ(**TINY_VQ)),
                jvp=jax.tree_util.tree_map(jnp.asarray, vq_to_jax(tvp)), tv=tv, tvp=tvp)


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


def _compare(jax_ids, torch_ids, n, jout, tout):
    assert len(jax_ids) == len(torch_ids) == n
    for si, (a, b) in enumerate(zip(jax_ids, torch_ids)):
        np.testing.assert_array_equal(a, b, err_msg=f"draw {si}")
    for a, b in zip(jout, tout):
        assert tuple(b.shape) == tuple(np.shape(a))
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4, rtol=0)


# ---- masks, index tables, init --------------------------------------------

@pytest.mark.parametrize("separator", [False, True])
def test_masks_and_index_tables_match_jax(separator):
    pn = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)
    for mf in (1, 2):
        np.testing.assert_array_equal(masks.level_index_1L(pn, mf, separator),
                                      jmasks.level_index_1L(pn, mf, separator))
        np.testing.assert_array_equal(masks.block_causal_mask(pn, mf, separator),
                                      jmasks.block_causal_mask(pn, mf, separator))
    for mask_first in (True, False):
        got = masks.type_index_1L(pn, separator, mask_first)
        np.testing.assert_array_equal(got, jmasks.type_index_1L(pn, separator, mask_first))
        assert got.dtype == np.int32 and got.shape == (1360 + 18 * separator,)
    for indep in (False, True):
        np.testing.assert_array_equal(masks.separate_decoding_mask(pn, separator, indep),
                                      jmasks.separate_decoding_mask(pn, separator, indep))
    for mask_first in (True, False):
        assert separator_mapping(mask_first) == jax_cv.separator_mapping(mask_first)


@pytest.mark.parametrize("var", [False, True])
def test_option_leaves_of_init_and_their_conversion(var):
    """The port's init has the JAX init's leaves and shapes with every
    option (type_embed, special_embed, shared_ada_lin, ada_gss in place of
    ada_lin); a JAX tree converts to the port and back bit for bit."""
    kw = dict(SEP_TP, shared_aln=True, bidirectional=True)
    if var:
        kw = {k: v for k, v in BASE.items() if k != "mask_factor"}
        kw["shared_aln"] = True
    jm = JVAR(JVCfg(**kw)) if var else JModel(JCfg(**kw))
    cfg = VARConfig(**kw) if var else ControlVARConfig(**kw)
    want = jax.eval_shape(jm.init_params, jax.random.key(0))
    got = (VARModel if var else ControlVARModel)(cfg, device="cpu").init_params(0)
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)
    assert shapes(to_jax_params(got, cfg)) == shapes(want)
    assert "ada_gss" in got["blocks"] and "ada_lin" not in got["blocks"]
    assert got["blocks"]["ada_gss"].shape == (2, 6, 128)
    if not var:
        assert got["special_embed"].shape == (6, 128) and got["type_embed"].shape == (2, 128)
    _, _, jp, tp = _models(kw, var)
    for a, b in zip(jax.tree_util.tree_leaves(to_jax_params(tp, cfg)),
                    jax.tree_util.tree_leaves(_tree(jp))):
        np.testing.assert_array_equal(a, b)


# ---- training forward -------------------------------------------------------

@pytest.mark.parametrize("mask_first", [True, False])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_forward_train_logits_match_jax(option, mask_first):
    kw = OPTIONS[option]
    jm, tm, jp, tp = _models(kw)
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    L_words = cfg.seq_len - cfg.num_sep_tokens
    x = rng.normal(0, 1, (2, L_words - cfg.first_l, 32)).astype(np.float32)
    labels, ct = np.array([1, 5]), np.array([0, 3])
    ctj = jnp.asarray(ct) if cfg.multi_cond else None
    want = jm.forward_train(jp, jnp.asarray(labels), jnp.asarray(x), ctj, mask_first=mask_first,
                            train=False, compute_dtype=jnp.float32)
    got = tm.forward_train(tp, torch.from_numpy(labels), torch.from_numpy(x),
                           torch.from_numpy(ct) if cfg.multi_cond else None,
                           mask_first=mask_first, train=False, compute_dtype=torch.float32)
    assert got.shape == (2, cfg.seq_len, cfg.head_vocab)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_bidirectional_sos_and_type_positions_follow_the_order():
    """The two stream orders give other logits (the sign of the SOS halves,
    the type index and the separators' order all flip); the port's sos of
    a bidirectional class-SOS model folds pos_start in before the sign."""
    _, tm, _, tp = _models(OPTIONS["all"])
    x = torch.randn(2, tm.cfg.seq_len - tm.cfg.num_sep_tokens - 2, 32,
                    generator=torch.Generator().manual_seed(0))
    args = (tp, torch.tensor([1, 5]), x, torch.tensor([0, 3]))
    a = tm.forward_train(*args, mask_first=True, train=False, compute_dtype=torch.float32)
    b = tm.forward_train(*args, mask_first=False, train=False, compute_dtype=torch.float32)
    assert not torch.allclose(a, b)
    _, bm, _, bp = _models(OPTIONS["bidirectional"])
    cond, sos = bm._sos(bp, torch.tensor([2]), None, True)
    want = (bp["class_emb"][2] + bp["pos_start"][0]) * torch.tensor([-1.0, 1.0])[:, None]
    torch.testing.assert_close(sos[0], want, rtol=0, atol=0)


# ---- shared_aln in the blocks ------------------------------------------------

def _blocks_inputs(L, C=128, B=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, L, C)).astype(np.float32),
            rng.normal(0, 1, (B, C)).astype(np.float32),
            rng.normal(0, 1, (B, L, C)).astype(np.float32))


@pytest.mark.parametrize("remat", tfm.REMAT_POLICIES)
def test_shared_aln_blocks_forward_and_grads_match_jax(remat):
    """blocks_forward of a shared_aln model in training under each remat
    policy: the output and the gradients of ada_gss, shared_ada_lin and
    every other block leaf against JAX's."""
    kw = OPTIONS["shared_aln"]
    _, tm, jp, tp = _models(kw)
    cfg, jcfg = tm.cfg, JCfg(**kw)
    x, cond, w = _blocks_inputs(cfg.seq_len)
    mask = masks.attn_mask_for_config(cfg)

    def jloss(bp, sl):
        y = jtfm.blocks_forward(bp, jnp.asarray(x), jnp.asarray(cond), jcfg, jnp.asarray(mask),
                                train=True, shared_lin=sl)
        return jnp.sum(y * jnp.asarray(w)), y

    (_, jy), (jg_b, jg_s) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp["blocks"], jp["shared_ada_lin"])
    bp = {k: (dict((kk, vv.clone().requires_grad_(True)) for kk, vv in v.items())
              if isinstance(v, dict) else v.clone().requires_grad_(True))
          for k, v in tp["blocks"].items()}
    sl = {k: v.clone().requires_grad_(True) for k, v in tp["shared_ada_lin"].items()}
    y = tfm.blocks_forward(bp, torch.from_numpy(x), torch.from_numpy(cond), cfg,
                           torch.from_numpy(mask), train=True, remat=remat, shared_lin=sl)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    got = {"shared/" + k: v.grad for k, v in sl.items()}
    want = {"shared/" + k: v for k, v in jg_s.items()}
    for k, v in bp.items():
        for kk, leaf in (v.items() if isinstance(v, dict) else [("", v)]):
            got[f"{k}/{kk}"] = leaf.grad
            want[f"{k}/{kk}"] = jg_b[k][kk] if kk else jg_b[k]
    assert "ada_gss/" in got
    for name, g in got.items():
        ww = np.asarray(want[name])
        np.testing.assert_allclose(g.numpy(), ww, rtol=0, atol=1e-4 * np.abs(ww).max() + 1e-12,
                                   err_msg=name)


# the port's decode layouts: (config overrides, init_kv_cache / blocks_decode arguments)
DECODE_LAYOUTS = {
    "paired": ({}, {}),
    "fused": ({}, dict(fused=True)),
    "inplace": ({}, dict(inplace=True)),
    "seg": ({}, None),
    "flat-odd-heads": (dict(embed_dim=192, num_heads=3), {}),
}


@pytest.mark.parametrize("layout", list(DECODE_LAYOUTS))
def test_shared_aln_decode_matches_jax(layout):
    """Two decode steps (scale 0, then scale 1 over the cached prefix) of a
    shared_aln model in each of the port's cache layouts against the JAX
    package's blocks_decode: the second step's hidden states."""
    over, kw = DECODE_LAYOUTS[layout]
    ckw = dict(OPTIONS["shared_aln"], **over)
    _, tm, jp, tp = _models(ckw)
    cfg, jcfg = tm.cfg, JCfg(**ckw)
    C = cfg.embed_dim
    rng = np.random.default_rng(3)
    x0, x1 = (rng.normal(0, 1, (4, n, C)).astype(np.float32) for n in (2, 8))
    cond = rng.normal(0, 1, (4, C)).astype(np.float32)
    jk, jv = jtfm.init_kv_cache(jcfg, 4, jcfg.seq_len, jnp.float32)
    _, jk, jv = jtfm.blocks_decode(jp["blocks"], jnp.asarray(x0), jnp.asarray(cond), jcfg, jk, jv,
                                   0, shared_lin=jp["shared_ada_lin"])
    want, _, _ = jtfm.blocks_decode(jp["blocks"], jnp.asarray(x1), jnp.asarray(cond), jcfg, jk,
                                    jv, 2, shared_lin=jp["shared_ada_lin"])
    t = torch.from_numpy
    sl = tp["shared_ada_lin"]
    if kw is None:
        _, k0, v0 = tfm.blocks_decode_seg(tp["blocks"], t(x0), t(cond), cfg, (), (),
                                          shared_lin=sl)
        got, _, _ = tfm.blocks_decode_seg(tp["blocks"], t(x1), t(cond), cfg, (k0,), (v0,),
                                          shared_lin=sl)
    else:
        ck, cv = tfm.init_kv_cache(cfg, 4, cfg.seq_len, torch.float32, "cpu",
                                   fused=kw.get("fused", False))
        step = dict(inplace=kw.get("inplace", False), shared_lin=sl)
        _, ck, cv = tfm.blocks_decode(tp["blocks"], t(x0), t(cond), cfg, ck, cv, 0, **step)
        got, _, _ = tfm.blocks_decode(tp["blocks"], t(x1), t(cond), cfg, ck, cv, 2, **step)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# ---- samplers -----------------------------------------------------------------

# case: (config, sampler arguments, JAX env switches, decode the canvases)
JOINT_CASES = {
    "stacked": (SEP_TP, dict(cache_mode="stacked"), {}, True),
    "stacked-image-first": (SEP_TP, dict(cache_mode="stacked", mask_first=False), {}, False),
    "seg-window1": (SEP_TP, dict(cache_mode="seg", kv_window=1), {}, False),
    "inplace-shared-aln": (dict(SEP_TP, shared_aln=True), dict(inplace_decode=True),
                           {"CONTROLVAR_INPLACE_DECODE": "1"}, False),
    "seg-shared-aln-image-first": (dict(SEP_TP, shared_aln=True),
                                   dict(cache_mode="seg", mask_first=False), {}, False),
    "indep-separator": (dict(BASE, multi_cond=True, separator=True, separate_decoding=True,
                             indep=True), dict(cache_mode="stacked"), {}, False),
    "class-sos-bidirectional-all": (dict(SEP_TP, multi_cond=False, bidirectional=True,
                                         shared_aln=True), dict(mask_first=False), {}, False),
}


@pytest.mark.parametrize("case", list(JOINT_CASES))
def test_joint_sampler_with_options_greedy_matches_jax(vq, monkeypatch, case):
    """StepwiseJointSampler of separator/type_pos (and shared_aln) models in
    each cache mode the JAX sampler takes, both stream orders: the drawn
    ids (separator slots included, cut to the vocabulary) at every scale and
    the canvases."""
    ckw, kw, env, decode = JOINT_CASES[case]
    jm, tm, jp, tp = _models(ckw)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kw = dict(kw)
    inplace = kw.pop("inplace_decode", False)
    jax_ids = _recorder(jax_stepwise, monkeypatch, traced=True)
    torch_ids = _recorder(torch_stepwise, monkeypatch)
    labels, ct = np.array([1, 5]), np.array([0, 2])
    common = dict(cfg_scale=2.0, top_k=1, top_p=0.0, **kw)
    js = jax_stepwise.StepwiseJointSampler(jm, vq["jv"], groups=(tuple(range(len(PNS))),),
                                           **common)
    js.compute_dtype = jnp.float32
    jout = js(jp, vq["jvp"], jnp.asarray(labels), jnp.asarray(ct), jax.random.key(7),
              decode_img=decode)
    jax.block_until_ready(jout)
    ts = torch_stepwise.StepwiseJointSampler(tm, vq["tv"], inplace_decode=inplace, device="cpu",
                                             compute_dtype=torch.float32, **common)
    tout = ts(tp, vq["tvp"], torch.from_numpy(labels), torch.from_numpy(ct),
              torch.Generator().manual_seed(7), decode_img=decode)
    _compare(jax_ids, torch_ids, len(PNS), jout, tout)
    assert all(int(ids.max()) < 64 for ids in torch_ids)
    if tm.cfg.separator:
        assert [ids.shape[1] for ids in torch_ids] == [2, 10, 20, 34]


@pytest.mark.parametrize("mask_first", [True, False])
def test_sample_joint_separate_with_separator_matches_jax(vq, monkeypatch, mask_first):
    ckw = dict(BASE, multi_cond=True, separator=True, separate_decoding=True)
    jm, tm, jp, tp = _models(ckw)
    jax_ids = _recorder(jax_cv, monkeypatch, traced=True)
    torch_ids = _recorder(torch_cv, monkeypatch)
    labels, ct = np.array([3, 6]), np.array([1, 0])
    args = dict(cfg_scale=2.0, top_k=1, top_p=0.0, decode_img=False, mask_first=mask_first)
    jout = jax.jit(lambda p, vp, l, c, k: jm.sample_joint_separate(
        p, vq["jv"], vp, l, c, k, compute_dtype=jnp.float32, **args))(
        jp, vq["jvp"], jnp.asarray(labels), jnp.asarray(ct), jax.random.key(4))
    jax.block_until_ready(jout)
    tout = tm.sample_joint_separate(tp, vq["tv"], vq["tvp"], torch.from_numpy(labels),
                                    torch.from_numpy(ct), torch.Generator().manual_seed(4),
                                    compute_dtype=torch.float32, **args)
    _compare(jax_ids, torch_ids, 2 * len(PNS), jout, tout)
    assert [ids.shape[1] for ids in torch_ids] == [1, 1, 5, 5, 10, 10, 17, 17]


@pytest.mark.parametrize("cache_mode", ["stacked", "seg"])
def test_shared_aln_var_sampling_matches_jax(vq, monkeypatch, cache_mode):
    kw = {k: v for k, v in BASE.items() if k != "mask_factor"}
    jm, tm, jp, tp = _models(dict(kw, shared_aln=True), var=True)
    jax_ids = _recorder(jax_stepwise, monkeypatch, traced=True)
    torch_ids = _recorder(torch_stepwise, monkeypatch)
    labels = np.array([2, 7])
    js = jax_stepwise.StepwiseVARSampler(jm, vq["jv"], cfg_scale=1.5, top_k=1, top_p=0.0,
                                         groups=(tuple(range(len(PNS))),), cache_mode=cache_mode)
    js.compute_dtype = jnp.float32
    jout = js(jp, vq["jvp"], jnp.asarray(labels), jax.random.key(3), decode_img=False)
    ts = torch_stepwise.StepwiseVARSampler(tm, vq["tv"], cfg_scale=1.5, top_k=1, top_p=0.0,
                                           cache_mode=cache_mode, device="cpu",
                                           compute_dtype=torch.float32)
    tout = ts(tp, vq["tvp"], torch.from_numpy(labels), torch.Generator().manual_seed(3),
              decode_img=False)
    _compare(jax_ids, torch_ids, len(PNS), [jout], [tout])


# case: (repeat_num, teacher-forced stream)
COND_CASES = {"r4-control": (4, "control"), "r3-control": (3, "control"),
              "r4-image": (4, "image")}


@pytest.mark.parametrize("case", list(COND_CASES))
def test_sample_cond_cfg_matches_jax_and_the_stepwise_sampler(vq, monkeypatch, case):
    """ControlVARModel.sample_cond_cfg with c_mask (or c_img) teacher forcing
    against the JAX package's (jitted) and against the port's
    StepwiseCondSampler on the same inputs: the ids of every draw and the
    canvases."""
    R, force = COND_CASES[case]
    jm, tm, jp, tp = _models(dict(BASE, multi_cond=True))
    rng = np.random.default_rng(5)
    forced = [rng.integers(0, 64, (2, pn * pn)) for pn in PNS]
    labels, ct = np.array([1, 4]), np.array([2, 0])
    key = "c_mask" if force == "control" else "c_img"
    args = dict(cfg_scales=(2.0, 1.0, 0.5), top_k=1, top_p=0.0, repeat_num=R, decode_img=False)
    jax_ids = _recorder(jax_cv, monkeypatch, traced=True)
    torch_ids = _recorder(torch_cv, monkeypatch)
    jout = jax.jit(lambda p, vp, l, c, k, f: jm.sample_cond_cfg(
        p, vq["jv"], vp, l, c, k, compute_dtype=jnp.float32, **{key: f}, **args))(
        jp, vq["jvp"], jnp.asarray(labels), jnp.asarray(ct), jax.random.key(2),
        [jnp.asarray(f, jnp.int32) for f in forced])
    jax.block_until_ready(jout)
    tout = tm.sample_cond_cfg(tp, vq["tv"], vq["tvp"], torch.from_numpy(labels),
                              torch.from_numpy(ct), torch.Generator().manual_seed(2),
                              compute_dtype=torch.float32,
                              **{key: [torch.from_numpy(f) for f in forced]}, **args)
    _compare(jax_ids, torch_ids, len(PNS), jout, tout)
    step_ids = _recorder(torch_stepwise, monkeypatch)
    ts = torch_stepwise.StepwiseCondSampler(
        tm, vq["tv"], cfg_scales=(2.0, 1.0, 0.5), top_k=1, top_p=0.0, force=force,
        repeat_num=R, device="cpu", compute_dtype=torch.float32)
    sout = ts(tp, vq["tvp"], torch.from_numpy(labels), torch.from_numpy(ct),
              torch.Generator().manual_seed(2), [torch.from_numpy(f) for f in forced],
              decode_img=False)
    for a, b in zip(torch_ids, step_ids):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tout, sout):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_sample_cond_cfg_decodes_and_draws_both_streams_unforced(vq):
    """Without teacher forcing both streams of the forced group are drawn
    (one draw over [control | image | both of the uncond group]); the
    decoded canvases are images in [0, 1]."""
    _, tm, _, tp = _models(dict(BASE, multi_cond=True))
    out = tm.sample_cond_cfg(tp, vq["tv"], vq["tvp"], torch.tensor([1, 4]), torch.tensor([2, 0]),
                             torch.Generator().manual_seed(3), top_k=10, top_p=0.9,
                             compute_dtype=torch.float32, repeat_num=3)
    for img in out:
        assert img.shape == (2, 64, 64, 3) and torch.isfinite(img).all()
        assert 0.0 <= float(img.min()) and float(img.max()) <= 1.0


def test_option_guards_keep_the_jax_asserts(vq):
    """The rejections the JAX package asserts, and only those: conditional
    sampling of separator/type_pos models, repeat_num outside {3, 4},
    type_pos in separate decoding, a separator in replace mode."""
    _, tm, _, tp = _models(SEP_TP)
    args = (tp, vq["tv"], vq["tvp"], torch.tensor([1]), torch.tensor([0]), torch.Generator())
    with pytest.raises(ValueError, match="separator/type_pos"):
        tm.sample_cond_cfg(*args)
    with pytest.raises(ValueError, match="separator/type_pos"):
        torch_stepwise.StepwiseCondSampler(tm, vq["tv"], device="cpu")
    _, plain, _, pp = _models(dict(BASE, multi_cond=True))
    with pytest.raises(ValueError, match="repeat_num"):
        plain.sample_cond_cfg(pp, *args[1:], repeat_num=5)
    sep_tp = ControlVARModel(ControlVARConfig(**dict(SEP_TP, separate_decoding=True)),
                             device="cpu")
    with pytest.raises(ValueError, match="type_pos"):
        sep_tp.sample_joint_separate(*args)
    replace = ControlVARModel(ControlVARConfig(**dict(BASE, mask_factor=1, separator=True)),
                              device="cpu")
    with pytest.raises(ValueError, match="separator"):
        replace.sample_joint_cfg(tp, vq["tv"], vq["tvp"], torch.tensor([1]), None,
                                 torch.Generator())
