"""The port's parity tooling (controlvar_tpu_torch/eval/parity.py and the
CLI's `parity`) against the JAX package's (controlvar_tpu/eval/parity.py),
on the CPU.

No upstream reference checkout is needed: the test writes a stub reference
tree (`models/__init__.py`, `models/vqvae.py`, `models/control_var.py`)
whose classes take the constructor arguments and the calls that both
parity modules make (`load_state_dict`, `.eval()`, `img_to_idxBl`, the
forward with `cond_type=` and `mask_first=`) and delegate to the JAX
package's models on the JAX importer's conversion of the state dict
(the forward with fp32 compute and `use_flash=False`). Both packages'
REFERENCE_ROOT point at that tree; afterwards sys.path is restored and the
stub's `models` modules leave sys.modules (a stub left in a test worker
would shadow a real reference for tests/reference_oracle.py).

Both packages read the same `.pth` files, written by the JAX exporter from
the port's init carried to the JAX layout: a ch-160 VQVAE (the width that
`token_stream_parity` fixes) at patch_nums (1, 2, 4) on two seeded 64x64
images, and a depth-2 multi_cond ControlVAR at the default patch_nums
(`logits_parity` builds its config from the depth alone), AdaLN gates
raised so that attention moves the logits. The JAX side against the stub
is the JAX stack against itself; the port against the stub is the
cross-package check:
  - the token-stream reports are equal key for key (bitwise);
  - a stub that flips one id per scale lowers `per_scale_match` by one id
    of each scale in both;
  - the port's logits are `within_tolerance` at the JAX default 5e-3 with
    every argmax equal (max |diff| below 1e-4: fp32 reassociation);
  - `cmd_parity --ckpt --out` of both CLIs writes reports with the same
    keys, flags and argmax rate, their diffs within 1e-4 (the JAX one is
    the JAX stack against itself, so the two are not bit-equal);
  - both CLIs exit with the same message without --ckpt or --images, and
    the port's functions raise without CUDA and without `device`.
"""
import contextlib
import json
import sys

import numpy as np
import pytest
import torch

from controlvar_tpu.ckpt import torch_export as jexport
from controlvar_tpu.cli import main as jcli
from controlvar_tpu.eval import parity as jparity

from controlvar_tpu_torch.ckpt.convert import to_jax_params
from controlvar_tpu_torch.cli import main as tcli
from controlvar_tpu_torch.config import VQVAEConfig, control_var_config_from_depth
from controlvar_tpu_torch.eval import parity as tparity
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.vqvae import VQVAE

PATCH_NUMS = (1, 2, 4)
DEPTH = 2
CPU = ["--device", "cpu"]

STUB_VQVAE = '''
import numpy as np
import torch

import jax.numpy as jnp

from controlvar_tpu.ckpt.torch_import import convert_vqvae_state_dict
from controlvar_tpu.config import VQVAEConfig
from controlvar_tpu.models.vqvae import VQVAE as _JVQVAE

FLIP = {flip}


class VQVAE:
    def __init__(self, vocab_size, z_channels, ch, v_patch_nums, test_mode=True):
        self.cfg = VQVAEConfig(vocab_size=vocab_size, z_channels=z_channels, ch=ch,
                               patch_nums=tuple(v_patch_nums))
        self.params = None

    def load_state_dict(self, sd, strict=True):
        self.params = convert_vqvae_state_dict({{k: v.numpy() for k, v in sd.items()}},
                                               self.cfg)

    def eval(self):
        return self

    def img_to_idxBl(self, x, v_patch_nums=None):
        img = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
        ids = [torch.from_numpy(np.array(t)).long()
               for t in _JVQVAE(self.cfg).img_to_ids(self.params, img)]
        if FLIP:  # one id of each scale moved to another code
            for t in ids:
                t.view(-1)[0] = (t.view(-1)[0] + 1) % self.cfg.vocab_size
        return ids
'''

STUB_CONTROL_VAR = '''
import numpy as np
import torch

import jax.numpy as jnp

from controlvar_tpu.ckpt.torch_import import convert_control_var_state_dict
from controlvar_tpu.config import control_var_config_from_depth
from controlvar_tpu.models.control_var import ControlVARModel


class ControlVAR:
    def __init__(self, vae_local, depth, embed_dim, num_heads, patch_nums, mask_factor,
                 multi_cond, cond_drop_rate, flash_if_available=True,
                 fused_if_available=True):
        self.cfg = control_var_config_from_depth(depth, multi_cond=multi_cond,
                                                 cond_drop_rate=cond_drop_rate)
        assert (self.cfg.embed_dim, self.cfg.num_heads, tuple(self.cfg.patch_nums),
                self.cfg.mask_factor) == (embed_dim, num_heads, tuple(patch_nums), mask_factor)
        self.params = None

    def eval(self):
        return self

    def load_state_dict(self, sd, strict=True):
        self.params = convert_control_var_state_dict({k: v.numpy() for k, v in sd.items()},
                                                     self.cfg)

    def __call__(self, labels, x_tf, cond_type=None, mask_first=True):
        out = ControlVARModel(self.cfg).forward_train(
            self.params, jnp.asarray(labels.numpy().astype(np.int32)),
            jnp.asarray(x_tf.numpy()), cond_type=jnp.asarray(cond_type.numpy().astype(np.int32)),
            mask_first=mask_first, train=False, compute_dtype=jnp.float32, use_flash=False)
        return torch.from_numpy(np.array(out))
'''


def _write_stub(root, flip=False):
    models = root / "models"
    models.mkdir(parents=True)
    (models / "__init__.py").write_text("")
    (models / "vqvae.py").write_text(STUB_VQVAE.format(flip=flip))
    (models / "control_var.py").write_text(STUB_CONTROL_VAR)
    return root


def _is_models(name):
    return name == "models" or name.startswith("models.")


@contextlib.contextmanager
def _reference(monkeypatch, root):
    """Both packages' REFERENCE_ROOT at the stub tree `root`; sys.path and
    every `models` module as they were afterwards."""
    path = list(sys.path)
    saved = {k: sys.modules.pop(k) for k in [k for k in sys.modules if _is_models(k)]}
    monkeypatch.setattr(jparity, "REFERENCE_ROOT", str(root))
    monkeypatch.setattr(tparity, "REFERENCE_ROOT", str(root))
    try:
        yield
    finally:
        sys.path[:] = path
        for k in [k for k in sys.modules if _is_models(k)]:
            del sys.modules[k]
        sys.modules.update(saved)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _vq_to_jax(tree):
    """The port's VQVAE tree as numpy in the JAX layout (OIHW -> HWIO)."""
    if isinstance(tree, dict):
        return {k: (v.numpy().transpose(2, 3, 1, 0) if k == "kernel" else _vq_to_jax(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_vq_to_jax(v) for v in tree]
    return tree.numpy()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """vae.pth (ch 160, patch_nums 1 2 4), model.pth (depth 2, multi_cond,
    default patch_nums, gates raised), both stub trees and the images."""
    from controlvar_tpu.config import VQVAEConfig as JVQCfg
    from controlvar_tpu.config import control_var_config_from_depth as j_cfg_from_depth

    d = tmp_path_factory.mktemp("parity")
    vq_cfg = VQVAEConfig(patch_nums=PATCH_NUMS)
    cfg = control_var_config_from_depth(DEPTH, multi_cond=True, cond_drop_rate=0.0)
    jp = to_jax_params(ControlVARModel(cfg, device="cpu").init_params(5), cfg)
    C = cfg.embed_dim
    jp["blocks"]["ada_lin"]["bias"][:, :C] += 10.0
    jp["blocks"]["ada_lin"]["bias"][:, C: 2 * C] += 1.0
    out = {"model": str(d / "model.pth"), "vae": str(d / "vae.pth")}
    jexport.save_torch_checkpoint(out["model"], jexport.export_control_var_state_dict(
        jp, j_cfg_from_depth(DEPTH, multi_cond=True, cond_drop_rate=0.0)))
    jvp = _vq_to_jax(VQVAE(vq_cfg, device="cpu").init_params(6))
    jexport.save_torch_checkpoint(out["vae"], jexport.export_vqvae_state_dict(
        jvp, JVQCfg(patch_nums=PATCH_NUMS)))
    out["stub"] = _write_stub(d / "stub")
    out["flip"] = _write_stub(d / "flip", flip=True)
    out["images"] = np.random.default_rng(0).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    return out


def _token_reports(monkeypatch, files, stub):
    with _reference(monkeypatch, files[stub]):
        want = jparity.token_stream_parity(files["vae"], files["images"], PATCH_NUMS)
        got = tparity.token_stream_parity(files["vae"], files["images"], PATCH_NUMS,
                                          device="cpu")
    return want, got


def test_token_stream_reports_are_equal(monkeypatch, files):
    want, got = _token_reports(monkeypatch, files, "stub")
    assert got == want
    assert got["bitwise"] and got["per_scale_match"] == [1.0] * len(PATCH_NUMS)
    assert "models" not in sys.modules


def test_a_flipped_id_per_scale_lowers_both_reports_equally(monkeypatch, files):
    want, got = _token_reports(monkeypatch, files, "flip")
    assert got == want
    B = files["images"].shape[0]
    np.testing.assert_allclose(got["per_scale_match"],
                               [1 - 1 / (B * p * p) for p in PATCH_NUMS], rtol=0, atol=1e-12)
    assert not got["bitwise"]
    assert got["total_match_rate"] == 1 - len(PATCH_NUMS) / sum(B * p * p for p in PATCH_NUMS)


def _logits_inputs(cfg, B=2, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.num_classes, (B,)).astype(np.int64),
            rng.integers(0, 4, (B,)).astype(np.int64),
            rng.standard_normal((B, cfg.seq_len - cfg.first_l, cfg.cvae)).astype(np.float32))


def test_logits_parity_is_within_the_jax_tolerance(monkeypatch, files):
    cfg = control_var_config_from_depth(DEPTH, multi_cond=True, cond_drop_rate=0.0)
    args = (files["model"], DEPTH, *_logits_inputs(cfg))
    with _reference(monkeypatch, files["stub"]):
        want = jparity.logits_parity(*args)
        got = tparity.logits_parity(*args, device="cpu")
    assert sorted(got) == sorted(want)
    assert want["max_abs_diff"] == 0.0 and want["argmax_match_rate"] == 1.0
    assert got["within_tolerance"] and got["argmax_match_rate"] == 1.0
    assert 0.0 < got["max_abs_diff"] < 1e-4 and got["mean_abs_diff"] <= got["max_abs_diff"]


def test_cmd_parity_writes_the_same_report(monkeypatch, files, tmp_path, capsys):
    argv = ["parity", "--depth", str(DEPTH), "--multi_cond", "--ckpt", files["model"]]
    reports = []
    with _reference(monkeypatch, files["stub"]):
        for name, main, extra in (("jax", jcli.main, []), ("port", tcli.main, CPU)):
            out = tmp_path / f"{name}.json"
            main([*argv, "--out", str(out), *extra])
            with open(out) as f:
                reports.append(json.load(f))
    want, got = reports
    assert list(got) == list(want) == ["logits"]
    assert sorted(got["logits"]) == sorted(want["logits"])
    for key in ("within_tolerance", "argmax_match_rate"):
        assert got["logits"][key] == want["logits"][key], key
    assert got["logits"]["within_tolerance"] and got["logits"]["argmax_match_rate"] == 1.0
    for key in ("max_abs_diff", "mean_abs_diff"):
        assert abs(got["logits"][key] - want["logits"][key]) < 1e-4, key
    assert "logits:" in capsys.readouterr().out


def test_cmd_parity_needs_an_input():
    for main, extra in ((jcli.main, []), (tcli.main, CPU)):
        with pytest.raises(SystemExit, match="parity needs --vae_ckpt --images and/or --ckpt"):
            main(["parity", "--depth", str(DEPTH), *extra])


def test_parity_functions_raise_without_cuda_and_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "missing.pth")
    with pytest.raises(RuntimeError, match="CUDA"):
        tparity.token_stream_parity(missing, np.zeros((1, 64, 64, 3), np.float32), PATCH_NUMS)
    with pytest.raises(RuntimeError, match="CUDA"):
        tparity.logits_parity(missing, DEPTH, np.zeros(1, np.int64), np.zeros(1, np.int64),
                              np.zeros((1, 8, 32), np.float32))
