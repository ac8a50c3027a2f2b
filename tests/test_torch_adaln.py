"""The blocks' AdaLN sites (`ops/adaln.py`): the plain versions, their
closed-form backward, the autograd Functions (with the plain versions in
the kernels' place) and the wrappers' dispatch on the CPU; the kernels
(`csrc/adaln.cu`), forward and backward, on the card.

Each site is held against a float64 formula of the same inputs, by a bound
that counts the roundings to the residual dtype the version makes: one per
rounded term, each at most half an ulp, 2^-8 of the term's magnitude in
bf16. The plain chain rounds LN, the modulated output, the bias add, the
gated branch, the drop-path product and the residual sum; the kernels round
once, at the store. fp32 arithmetic (the statistics of a row of 1024 or 1920)
is held within 4e-6 of the output's largest magnitude, and an fp32 residual
within 1e-5 of each term's.

Tests marked `card` need a CUDA device and skip without one. This file
imports no JAX, so on the card they run without the repository's conftest:

    python -m pytest tests/test_torch_adaln.py -m card --noconftest -p no:cacheprovider
"""
import dataclasses

import pytest
import torch

from controlvar_tpu_torch.config import ControlVARConfig, VARConfig, VQVAEConfig
from controlvar_tpu_torch.ops import adaln

EPS = 1e-6
WIDTHS = (1024, 1920)                 # ControlVAR-d16, ControlVAR-d30
ULP_BF16 = 2.0 ** -8                  # half an ulp of bf16, relative
REL_FP32 = 1e-5
SLACK = 4e-6                          # fp32 statistics, of the output's largest magnitude
STREAM_TOKENS = (1, 4, 9, 16, 25, 36, 64, 100, 169, 256)   # pn^2 of d16's ten scales
SITES = ("norm", "add_norm", "add")


# ---- inputs and the float64 formula ------------------------------------------

def _modulation(kind, B, C, g):
    """A layer's (B, 6, C) fp32 modulation as the blocks see it: "layer" a
    strided view of all layers' (the einsum's layout), "shared_aln" one made
    by `_ada_all_layers` of a shared_aln model, "broadcast" one row for all.
    Returns its rows (g1, g2, s1, s2, sh1, sh2), cut as the blocks cut them."""
    from controlvar_tpu_torch.models import transformer as tfm

    def rows(*lead):
        a = 0.3 * torch.randn(*lead, 6, C, generator=g)
        a[..., :2, :] += 1.0    # the gates near 1, the scales and shifts near 0
        return a

    cfg = VARConfig(depth=2, embed_dim=C, num_heads=C // 64, shared_aln=True)
    if kind == "layer":
        ada = rows(B, 2).permute(1, 0, 2, 3)[1]
    elif kind == "broadcast":
        ada = rows(1)
    else:
        shared_lin = {"kernel": torch.randn(C, 6 * C, generator=g) / C,
                      "bias": rows().reshape(6 * C)}
        ada = tfm._ada_all_layers({"ada_gss": rows(2)}, torch.randn(B, C, generator=g), cfg,
                                  shared_lin)[1]
    return dict(zip(("g1", "g2", "s1", "s2", "sh1", "sh2"), tfm._ada_parts(ada, cfg)))


def _inputs(site, B, l, C, dtype, branch_dtype, keep, modulation, seed=0, device="cpu"):
    """Values exact in their dtypes: h with a mean per token, the branch and
    its bias in branch_dtype, keep (B,) as drop path makes it (0 or 1/0.8)."""
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(B, l, C, generator=g) + 2.0 * torch.randn(B, l, 1, generator=g)
    ins = dict(h=h.to(dtype), **_modulation(modulation, B, C, g))
    if site != "norm":
        ins["y"] = (0.5 * torch.randn(B, l, C, generator=g)).to(branch_dtype)
        ins["bias"] = (0.1 * torch.randn(C, generator=g)).to(branch_dtype)
        ins["keep"] = None
        if keep:
            ins["keep"] = ((torch.arange(B) % 3 != 1).float() / 0.8).to(dtype)
    return {k: (v if v is None else v.to(device)) for k, v in ins.items()}


def _norm64(h, scale, shift):
    """float64 LN(h) (1 + s) + sh, and the magnitudes of its two rounded terms."""
    h = h.double()
    mean = h.mean(-1, keepdim=True)
    ln = (h - mean) / torch.sqrt(((h - mean) ** 2).mean(-1, keepdim=True) + EPS)
    modulated = ln * (scale.double() + 1.0)
    out = modulated + shift.double()
    return out, modulated.abs() + out.abs()


def _add64(h, y, bias, gate, keep):
    """float64 h + g (y + b) keep, and the magnitudes of the chain's rounded
    terms (the bias add, the gate, the drop-path product, the sum)."""
    k = 1.0 if keep is None else keep.double().reshape(-1, 1, 1)
    branch = (y.double() + bias.double()) * gate.double() * k
    out = h.double() + branch
    return out, 3.0 * branch.abs() + out.abs()


def _within(what, got, want, mag, dtype, roundings=True):
    """got against the float64 want: each rounded term's half ulp (`mag`, or
    the output alone where roundings is False) plus SLACK."""
    rel = ULP_BF16 if dtype == torch.bfloat16 else REL_FP32
    want, mag = want.cpu(), mag.cpu()
    bound = rel * (mag if roundings else want.abs()) + SLACK * want.abs().amax()
    err = (got.double().cpu() - want).abs()
    worst = float((err / bound).max())
    assert torch.isfinite(got).all() and worst <= 1.0, f"{what}: largest err/bound {worst:.3f}"
    return bound


def _check_plain(site, ins, dtype):
    """The plain version against the formula, by the chain's roundings;
    returns the bound of each output."""
    h = ins["h"]
    if site == "norm":
        want, mag = _norm64(h, ins["s1"], ins["sh1"])
        return [_within("hn", _call(site, ins, "_plain"), want, mag, dtype)]
    if site == "add":
        want, mag = _add64(h, ins["y"], ins["bias"], ins["g2"], ins["keep"])
        return [_within("h''", _call(site, ins, "_plain"), want, mag, dtype)]
    got_h, got_n = _call(site, ins, "_plain")
    want, mag = _add64(h, ins["y"], ins["bias"], ins["g1"], ins["keep"])
    bounds = [_within("h'", got_h, want, mag, dtype)]
    # the chain normalises its own rounded h'
    want, mag = _norm64(got_h, ins["s2"], ins["sh2"])
    return bounds + [_within("hn", got_n, want, mag, dtype)]


# ---- the plain versions (CPU) -----------------------------------------------

def _plain_cases():
    for site in SITES:
        for C in WIDTHS:
            for dtype in (torch.bfloat16, torch.float32):
                # an fp32 branch and bias: a tensor-parallel group's sum under bf16
                tp = site != "norm" and dtype == torch.bfloat16
                for branch in (dtype, torch.float32) if tp else (dtype,):
                    for keep in ((False,) if site == "norm" else (False, True)):
                        for modulation in ("layer", "shared_aln"):
                            yield pytest.param(
                                site, C, dtype, branch, keep, modulation,
                                id=f"{site}-C{C}-{str(dtype)[6:]}-y_{str(branch)[6:]}"
                                   f"{'-keep' if keep else ''}-{modulation}")


@pytest.mark.parametrize("site,C,dtype,branch,keep,modulation", list(_plain_cases()))
def test_plain_sites_against_float64(site, C, dtype, branch, keep, modulation):
    """The eager chains at d16's and d30's widths, bf16 and fp32 residuals,
    an fp32 branch with fp32 bias (tensor parallel), with and without drop
    path, per-layer and shared_aln modulations."""
    _check_plain(site, _inputs(site, 3, 7, C, dtype, branch, keep, modulation), dtype)


def _call(site, ins, fn_suffix=""):
    fn = getattr(adaln, f"adaln_{site}{fn_suffix}")
    if site == "norm":
        return fn(ins["h"], ins["s1"], ins["sh1"], EPS)
    if site == "add":
        return fn(ins["h"], ins["y"], ins["bias"], ins["g2"], ins["keep"])
    return fn(ins["h"], ins["y"], ins["bias"], ins["g1"], ins["s2"], ins["sh2"], EPS,
              ins["keep"])


def _launches():
    return tuple(getattr(adaln, f"adaln_{s}").launches for s in SITES)


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("site", SITES)
def test_wrappers_take_the_plain_path_on_the_cpu(site, grad):
    """On CPU tensors each wrapper returns its plain version's tensors bit
    for bit, under autograd too (the gradient flows through the chain), and
    launches nothing."""
    ins = _inputs(site, 2, 5, 1024, torch.bfloat16, torch.bfloat16, True, "layer")
    if grad:
        ins = {k: (v if v is None else v.float().requires_grad_(True)) for k, v in ins.items()}
    before = _launches()
    with torch.set_grad_enabled(grad):
        got, want = _flat(_call(site, ins)), _flat(_call(site, ins, "_plain"))
    assert _launches() == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if grad:
        sum(t.sum() for t in got).backward()
        assert ins["h"].grad is not None


@pytest.mark.parametrize("site", SITES)
def test_dispatch_rule(site, monkeypatch):
    """Off the CPU: under autograd, when an input requires grad, the
    autograd Function, whose forward is the kernel; else the kernel called
    directly. The kernels take CUDA tensors only (meta tensors stand in for
    a device here): both routes reach the kernel, inside the Function under
    autograd, and raise there."""
    ins = _inputs(site, 2, 5, 64, torch.bfloat16, torch.bfloat16, False, "layer",
                  device="meta")
    ins["h"].requires_grad_(True)
    kernel = getattr(adaln, KERNELS[site])
    reached = []

    def spy(*args, **kw):
        # autograd is off inside a Function's forward, on at a direct call
        reached.append(torch.is_grad_enabled())
        return kernel(*args, **kw)

    monkeypatch.setattr(adaln, KERNELS[site], spy)
    before = _launches()
    with pytest.raises(ValueError, match="unsupported device meta"):
        _call(site, ins)
    with torch.no_grad(), pytest.raises(ValueError, match="unsupported device meta"):
        _call(site, ins)
    assert reached == [False, False]
    with pytest.raises(ValueError, match="unsupported device meta"):
        ins["h"].requires_grad_(False)
        _call(site, ins)
    assert reached == [False, False, True]
    assert _launches() == before


# ---- the backward: closed form (CPU) ------------------------------------------

KERNELS = {"norm": "_norm_kernel", "add_norm": "_add_norm_kernel", "add": "_add_kernel"}
BWD_KERNELS = {"norm": "_norm_bwd_kernel", "add_norm": "_add_norm_bwd_kernel",
               "add": "_add_bwd_kernel"}
NEEDS = {"norm": ("h", "s1", "sh1"), "add_norm": ("h", "y", "bias", "g1", "s2", "sh2"),
         "add": ("h", "y", "bias", "g2")}


def _upstream(site, ins, seed=1):
    """Random gradients of the site's outputs, in the residual dtype."""
    g = torch.Generator().manual_seed(seed)
    h = ins["h"]
    n = 2 if site == "add_norm" else 1
    return [torch.randn(h.shape, generator=g).to(h.dtype).to(h.device) for _ in range(n)]


def _formula_grads(site, ins, ups):
    """Autograd of the float64 formula (`_norm64`, `_add64`: the kernels'
    forward, no intermediate rounding) at the inputs' values: the gradients
    of NEEDS[site] for the upstream gradients `ups`."""
    leaves = {k: ins[k].detach().double().requires_grad_(True) for k in NEEDS[site]}
    keep = ins.get("keep")
    if site == "norm":
        outs = [_norm64(leaves["h"], leaves["s1"], leaves["sh1"])[0]]
    elif site == "add":
        outs = [_add64(leaves["h"], leaves["y"], leaves["bias"], leaves["g2"], keep)[0]]
    else:
        h1 = _add64(leaves["h"], leaves["y"], leaves["bias"], leaves["g1"], keep)[0]
        outs = [h1, _norm64(h1, leaves["s2"], leaves["sh2"])[0]]
    torch.autograd.backward(outs, [u.double() for u in ups])
    return [leaves[k].grad for k in NEEDS[site]]


def _bwd(site, ins, ups, suffix="_plain", needs=None):
    """A site's backward (the plain version, or a kernel launcher given by
    suffix=None) on ins and the upstream gradients."""
    kw = {} if needs is None else {"needs": needs}
    fn = (getattr(adaln, f"adaln_{site}_bwd_plain") if suffix == "_plain" else
          getattr(adaln, BWD_KERNELS[site]))
    if site == "norm":
        return fn(ins["h"], ins["s1"], ups[0], EPS, **kw)
    if site == "add":
        return fn(ins["y"], ins["bias"], ins["g2"], ups[0], ins["keep"], **kw)
    return fn(ins["h"], ins["y"], ins["bias"], ins["g1"], ins["s2"], ups[0], ups[1], EPS,
              ins["keep"], **kw)


def _check_grads(what, got, want, ins, names, rel_sum):
    """Each gradient in its input's dtype and shape, against float64 `want`:
    h's and y's within one rounding to their dtype plus 1e-5 of their
    largest (fp32 arithmetic), the row and bias sums within rel_sum of their
    norm."""
    for name, a, w in zip(names, got, want):
        ref = ins[name]
        assert a.dtype == ref.dtype and a.shape == ref.shape, (what, name, a.dtype, a.shape)
        a, w = a.double().cpu(), w.double().cpu()
        assert torch.isfinite(a).all(), (what, name)
        if name in ("h", "y"):
            rel = ULP_BF16 if ref.dtype == torch.bfloat16 else REL_FP32
            bound = rel * w.abs() + 1e-5 * w.abs().amax()
            worst = float(((a - w).abs() / bound).max())
            assert worst <= 1.0, f"{what} d{name}: largest err/bound {worst:.3f}"
        else:
            gap = float((a - w).norm() / w.norm())
            assert gap <= rel_sum, f"{what} d{name}: relative L2 {gap:.3e}"


def _bwd_cases():
    for site in SITES:
        for dtype in (torch.bfloat16, torch.float32):
            tp = site != "norm" and dtype == torch.bfloat16
            for branch in (dtype, torch.float32) if tp else (dtype,):
                for keep in ((False,) if site == "norm" else (False, True)):
                    for modulation in ("layer", "broadcast"):
                        yield pytest.param(
                            site, dtype, branch, keep, modulation,
                            id=f"{site}-{str(dtype)[6:]}-y_{str(branch)[6:]}"
                               f"{'-keep' if keep else ''}-{modulation}")


@pytest.mark.parametrize("site,dtype,branch,keep,modulation", list(_bwd_cases()))
def test_plain_backward_against_float64_autograd(site, dtype, branch, keep, modulation):
    """`*_bwd_plain` against autograd of the float64 formula: on float64
    inputs to 1e-12 (the closed form itself), and on the inputs' own dtypes
    (bf16 or fp32 residual, a tensor-parallel fp32 branch and bias, drop
    path or none, (B, 1, C) or (1, 1, C) rows, whose gradient sums the batch
    too) within one rounding (fp32 sums: 1e-5)."""
    ins = _inputs(site, 3, 7, 1024, dtype, branch, keep, modulation)
    if site != "norm":
        ins["bias"] = ins["bias"].float()      # the parameter's dtype; exact in y's
    ups = _upstream(site, ins)
    want = _formula_grads(site, ins, ups)
    f64 = {k: (v if v is None else v.double()) for k, v in ins.items()}
    exact = _bwd(site, f64, [u.double() for u in ups])
    for name, a, w in zip(NEEDS[site], exact, want):
        assert a.dtype == torch.float64, name
        assert float((a - w).abs().max()) <= 1e-12 * float(w.abs().max()), name
    _check_grads(site, _bwd(site, ins, ups), want, ins, NEEDS[site], 1e-5)


@pytest.mark.parametrize("site", SITES)
def test_plain_backward_needs(site):
    """A gradient not asked for is None; the others are those of the full
    call bit for bit; `adaln_add`'s dh is the upstream gradient itself."""
    ins = _inputs(site, 2, 5, 64, torch.bfloat16, torch.float32, True, "layer")
    ups = _upstream(site, ins)
    full = _bwd(site, ins, ups)
    n = len(NEEDS[site])
    for which in ([i % 2 == 0 for i in range(n)], [i % 2 == 1 for i in range(n)]):
        part = _bwd(site, ins, ups, needs=tuple(which))
        for asked, a, b in zip(which, part, full):
            assert (a is None) != asked and (a is None or torch.equal(a, b))
    if site == "add":
        assert full[0] is ups[0]


def _plain_in_the_kernels_place(monkeypatch):
    """Route every site with an input that requires grad through its
    Function on the CPU, with the plain forward and backward in the
    kernels' place (the Functions' plumbing, without a device)."""
    route = adaln._route
    monkeypatch.setattr(adaln, "_route", lambda *t: "function" if torch.is_grad_enabled() and any(
        a is not None and a.requires_grad for a in t) else route(*t))
    for site in SITES:
        monkeypatch.setattr(adaln, KERNELS[site], getattr(adaln, f"adaln_{site}_plain"))
        monkeypatch.setattr(adaln, BWD_KERNELS[site], getattr(adaln, f"adaln_{site}_bwd_plain"))


@pytest.mark.parametrize("modulation", ["layer", "broadcast"])
@pytest.mark.parametrize("site", SITES)
def test_functions_against_float64_autograd(site, modulation, monkeypatch):
    """Each Function (plain versions in the kernels' place) under autograd
    on float64 inputs: every input's gradient that of the float64 formula,
    keep's none."""
    _plain_in_the_kernels_place(monkeypatch)
    ins = _inputs(site, 3, 7, 64, torch.float32, torch.float32, True, modulation)
    ins = {k: (v if v is None else v.double().requires_grad_(k in NEEDS[site]))
           for k, v in ins.items()}
    ups = [u.double() for u in _upstream(site, ins)]
    torch.autograd.backward(list(_flat(_call(site, ins))), ups)
    want = _formula_grads(site, ins, ups)
    for name, w in zip(NEEDS[site], want):
        got = ins[name].grad
        assert got.shape == ins[name].shape
        assert float((got - w).abs().max()) <= 1e-12 * float(w.abs().max()), name
    assert ins.get("keep") is None or ins["keep"].grad is None


@pytest.mark.parametrize("remat", ["full", "dots", "dots_attn"])
def test_blocks_through_the_functions(remat, monkeypatch):
    """A tiny `blocks_forward` train step with drop path, under each remat
    policy, through the Functions (plain versions in the kernels' place):
    the gradient of every block leaf and of the input that of the plain
    chains within fp32 arithmetic; each site's forward runs twice a layer
    (forward and recompute) and its backward once."""
    import numpy as np

    from controlvar_tpu_torch.models import transformer as tfm

    cfg = VARConfig(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 4),
                    drop_path_rate=0.1)
    g = torch.Generator().manual_seed(0)
    bp = tfm.init_block_params(g, cfg)
    bp["ada_lin"]["bias"][:, :256] += 1.0     # the gates open
    L = int(np.sum(np.square(cfg.patch_nums)))
    x0, cond = torch.randn(2, L, 128, generator=g), torch.randn(2, 128, generator=g)
    w = torch.randn(2, L, 128, generator=g)
    mask = torch.ones(L, L, dtype=torch.bool).tril()

    def grads():
        p = {k: ({kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.clone().requires_grad_(True))
             for k, v in bp.items()}
        x = x0.clone().requires_grad_(True)
        out = tfm.blocks_forward(p, x, cond, cfg, mask, train=True,
                                 generator=torch.Generator().manual_seed(5), remat=remat)
        (out * w).sum().backward()
        return [x.grad] + [leaf.grad for v in p.values()
                           for leaf in (v.values() if isinstance(v, dict) else [v])]

    want = grads()
    _plain_in_the_kernels_place(monkeypatch)
    counted = {}
    for site in SITES:
        for attr, name in ((KERNELS, "fwd"), (BWD_KERNELS, "bwd")):
            fn = getattr(adaln, attr[site])

            def counting(*a, _fn=fn, _key=(site, name), **kw):
                counted[_key] = counted.get(_key, 0) + 1
                return _fn(*a, **kw)

            monkeypatch.setattr(adaln, attr[site], counting)
    got = grads()
    assert counted == {(s, k): n for s in SITES
                       for k, n in (("fwd", 2 * cfg.depth), ("bwd", cfg.depth))}
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


# ---- the kernels (card) --------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check_kernel(site, ins, dtype):
    """The kernel against the formula (one rounding), and against its plain
    version within the sum of both bounds; add_norm's two normalisations
    read different h' (the chain's rounded one), so there the two are held
    to the formula alone."""
    with torch.no_grad():
        got = _flat(_call(site, ins))
        plain = _flat(_call(site, ins, "_plain"))
    h = ins["h"]
    bounds = []
    if site != "norm":
        gate = ins["g1"] if site == "add_norm" else ins["g2"]
        want_h, mag_h = _add64(h, ins["y"], ins["bias"], gate, ins["keep"])
        bounds.append(_within(f"{site} h'", got[0], want_h, mag_h, dtype, roundings=False))
    if site != "add":
        # the kernel normalises h' as computed, before its store
        want, mag = (_norm64(h, ins["s1"], ins["sh1"]) if site == "norm" else
                     _norm64(want_h, ins["s2"], ins["sh2"]))
        bounds.append(_within(f"{site} hn", got[-1], want, mag, dtype, roundings=False))
    for i, (a, b, bk, bp) in enumerate(zip(got, plain, bounds, _check_plain(site, ins, dtype))):
        if site == "add_norm" and i == 1:
            continue
        err = (a.double() - b.double()).abs().cpu()
        assert (err <= bk + bp).all(), f"{site} output {i}: kernel against plain"


@pytest.mark.card
@pytest.mark.parametrize("rows", [4, 64])
@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("site", SITES)
def test_kernel_at_every_scale(cuda, site, dtype, C, rows):
    """Every scale's tokens (pn^2 a stream, two streams) at 4 and 64 CFG
    rows; each launch adds one to its counter."""
    for i, n in enumerate(STREAM_TOKENS):
        ins = _inputs(site, rows, 2 * n, C, dtype, dtype, False, "layer", seed=i, device=cuda)
        before = _launches()
        _check_kernel(site, ins, dtype)
        assert [b - a for a, b in zip(before, _launches())] == [int(s == site) for s in SITES]


@pytest.mark.card
@pytest.mark.parametrize("modulation", ["layer", "shared_aln", "broadcast"])
@pytest.mark.parametrize("variant", ["fp32_branch", "keep", "wide"])
@pytest.mark.parametrize("site", SITES)
def test_kernel_variants(cuda, site, variant, modulation):
    """The tensor-parallel fp32 branch and bias, drop path, a width above
    2048 (1024-thread blocks), under each modulation layout."""
    C = 2304 if variant == "wide" else 1920
    branch = torch.float32 if variant == "fp32_branch" else torch.bfloat16
    ins = _inputs(site, 6, 50, C, torch.bfloat16, branch, variant == "keep", modulation,
                  device=cuda)
    _check_kernel(site, ins, torch.bfloat16)


def _tiny(**kw):
    return ControlVARConfig(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 4),
                            vocab_size=128, num_classes=10, **kw)


def _card_bwd_case(site, B, l, C, dtype, branch, keep, modulation, cuda, seed=0):
    ins = _inputs(site, B, l, C, dtype, branch, keep, modulation, seed=seed, device=cuda)
    if site != "norm":
        ins["bias"] = ins["bias"].float()
    return ins, _upstream(site, ins, seed + 1)


def _check_bwd_kernel(site, ins, ups, needs=None):
    """The backward kernel against the plain backward on the same values in
    float64 (`_check_grads`: h's and y's within one rounding, the row and
    bias sums within 1e-4 relative L2); a second launch on the same inputs
    gives the same gradients bit for bit; each launch adds one to the
    site's bwd_launches."""
    before = getattr(adaln, f"adaln_{site}").bwd_launches
    got = _bwd(site, ins, ups, suffix=None, needs=needs)
    again = _bwd(site, ins, ups, suffix=None, needs=needs)
    assert getattr(adaln, f"adaln_{site}").bwd_launches == before + 2
    f64 = {k: (v if v is None else v.double()) for k, v in ins.items()}
    want = _bwd(site, f64, [u.double() for u in ups], needs=needs)
    names = [n for n, w in zip(NEEDS[site], want) if w is not None]
    assert [n for n, a in zip(NEEDS[site], got) if a is not None] == names
    got, again, want = ([t for t in ts if t is not None] for ts in (got, again, want))
    _check_grads(site, got, want, ins, names, 1e-4)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.card
@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("site", SITES)
def test_backward_kernel_at_the_train_step(cuda, site, dtype, C):
    """Each backward kernel at the d30 train step's (8, 1360, C) with drop
    path and a layer's modulation rows, C 1024 and 1920, bf16 and fp32."""
    _check_bwd_kernel(site, *_card_bwd_case(site, 8, 1360, C, dtype, dtype, True, "layer",
                                            cuda))


@pytest.mark.card
@pytest.mark.parametrize("variant", ["fp32_branch", "broadcast", "shared_aln", "no_keep",
                                     "needs", "wide", "ragged"])
@pytest.mark.parametrize("site", SITES)
def test_backward_kernel_variants(cuda, site, variant):
    """The tensor-parallel fp32 branch and bias, (1, 1, C) rows (the batch
    summed too), shared_aln rows, no drop path, part of the gradients asked
    for, C 2304 (512-thread blocks) and a token count that no block size
    divides."""
    C = 2304 if variant == "wide" else 1920
    branch = torch.float32 if variant == "fp32_branch" else torch.bfloat16
    modulation = {"broadcast": "broadcast", "shared_aln": "shared_aln"}.get(variant, "layer")
    l = 1009 if variant == "ragged" else 50
    ins, ups = _card_bwd_case(site, 6, l, C, torch.bfloat16, branch, variant != "no_keep",
                              modulation, cuda)
    needs = None
    if variant == "needs":
        needs = tuple(i % 2 == 1 for i in range(len(NEEDS[site])))
    _check_bwd_kernel(site, ins, ups, needs)


@pytest.mark.card
def test_blocks_decode_launches(cuda):
    """One blocks_decode adds 3 x depth launches under no_grad (one a site a
    layer); under autograd with parameters that require grad it takes the
    Functions, as many forward launches, and its backward one backward
    launch a layer of `adaln_add_norm` and `adaln_add`; none of
    `adaln_norm`, whose output reaches the loss only through K1, which has
    no backward."""
    from controlvar_tpu_torch.models import transformer as tfm

    cfg = _tiny()
    g = torch.Generator().manual_seed(0)
    bp = {k: (v.to(cuda, torch.bfloat16) if not isinstance(v, dict) else
              {kk: vv.to(cuda, torch.bfloat16) for kk, vv in v.items()})
          for k, v in tfm.init_block_params(g, cfg).items()}
    x = torch.randn(4, 5, 128, generator=g).to(cuda, torch.bfloat16)
    cond = torch.randn(4, 128, generator=g).to(cuda)
    bwd_launches = lambda: [getattr(adaln, f"adaln_{s}").bwd_launches for s in SITES]
    for grad in (False, True):
        for leaf in (bp["qkv_kernel"], bp["ada_lin"]["kernel"]):
            leaf.requires_grad_(grad)
        ck, cv = tfm.init_kv_cache(cfg, 4, 21, torch.bfloat16, cuda)
        before, bwd_before = _launches(), bwd_launches()
        with torch.set_grad_enabled(grad):
            out = tfm.blocks_decode(bp, x, cond, cfg, ck, cv, 0)[0]
        assert [b - a for a, b in zip(before, _launches())] == [cfg.depth] * 3
        if grad:
            out.float().sum().backward()
            assert bp["ada_lin"]["kernel"].grad is not None
        assert ([b - a for a, b in zip(bwd_before, bwd_launches())]
                == [0] + [cfg.depth if grad else 0] * 2)


@pytest.mark.card
def test_d30_width_conditional_call_against_the_chain(cuda, monkeypatch):
    """A depth-2 ControlVAR at d30's width (C 1920, 30 heads, cos_attn),
    greedy, 4-way CFG, the control stream forced as control_conditioned
    forces it: the combined logits of every draw with the kernels (bf16),
    with the eager chains (bf16) and with the chains in fp32 (on the CPU:
    K1 takes bf16 alone), each run fed the kernels' ids. Tolerance: the
    kernels and the chains are two bf16 roundings of one fp32 computation,
    so their logits lie within twice the chain's own distance from the fp32
    logits; the kernels round less, so their mean distance from fp32 is no
    larger than the chain's."""
    import controlvar_tpu_torch.eval.stepwise as stepwise
    import controlvar_tpu_torch.models.transformer as tfm
    from controlvar_tpu_torch.config import control_var_config_from_depth
    from controlvar_tpu_torch.device import tree_to
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE

    pns = (1, 2, 4)
    cfg = dataclasses.replace(control_var_config_from_depth(30, multi_cond=True), depth=2,
                              patch_nums=pns)
    params = ControlVARModel(cfg, device="cpu").init_params(0)
    C = cfg.embed_dim
    params["blocks"]["ada_lin"]["bias"][:, :C] += 10.0      # let attention move the output
    params["blocks"]["ada_lin"]["bias"][:, C: 2 * C] += 1.0
    vq_cfg = VQVAEConfig(ch=32, patch_nums=pns)
    vq_params = VQVAE(vq_cfg, device="cpu").init_params(0)
    g = torch.Generator().manual_seed(4)
    forced = [torch.randint(0, 4096, (2, pn * pn), generator=g) for pn in pns]
    labels, ct = torch.tensor([3, 977]), torch.tensor([1, 2])

    draw = stepwise.sample_top_k_top_p
    ids = []

    def run(dtype, device, plain):
        """The combined logits of every draw; the first run draws, the
        others replay its ids."""
        logits, replay = [], list(ids)

        def spy(lg, *a, **kw):
            logits.append(lg.float().cpu())
            if replay:
                return replay[len(logits) - 1].to(lg.device)
            ids.append(draw(lg, *a, **kw))
            return ids[-1]

        monkeypatch.setattr(stepwise, "sample_top_k_top_p", spy)
        for site in SITES:
            fn = getattr(adaln, f"adaln_{site}" + ("_plain" if plain else ""))
            monkeypatch.setattr(tfm, f"adaln_{site}", fn)
        on = lambda t: tree_to(t, device)
        sampler = stepwise.StepwiseCondSampler(
            ControlVARModel(cfg, device=device), VQVAE(vq_cfg, device=device),
            cfg_scales=(4.0, 4.0, 4.0), top_k=1, top_p=0.0, force="control", decode="image",
            device=device, compute_dtype=dtype)
        before = _launches()
        with torch.no_grad():
            sampler(sampler.prepare_params(on(params)), on(vq_params), labels, ct,
                    torch.Generator().manual_seed(9), forced, decode_img=False)
        launched = sum(b - a for a, b in zip(before, _launches()))
        assert launched == (0 if plain else 3 * cfg.depth * len(pns))
        return logits

    kernel = run(torch.bfloat16, cuda, plain=False)
    chain = run(torch.bfloat16, cuda, plain=True)
    ref = run(torch.float32, torch.device("cpu"), plain=True)
    assert len(kernel) == len(chain) == len(ref) == len(pns)
    for si, (k, c, r) in enumerate(zip(kernel, chain, ref)):
        chain_gap = (c - r).abs()
        assert float((k - c).abs().max()) <= 2.0 * float(chain_gap.max()), f"scale {si}"
        assert float((k - r).abs().mean()) <= float(chain_gap.mean()), f"scale {si}"
