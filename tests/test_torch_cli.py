"""The port's command line (controlvar_tpu_torch/cli/main.py) against the
JAX package's (controlvar_tpu/cli/main.py).

- `build_parser`: every subcommand's option strings, defaults, choices,
  nargs and types equal the JAX parser's, `parity` included (its reports
  are held in tests/test_torch_parity.py); the port's `--device` is the
  only difference.
- `_configs`: the model and tokenizer configs equal the JAX ones field by
  field for every ablation flag; the committed YAML recipes merge the same.
- Both CLIs on the same `.pth` files, written by the JAX package's
  `ckpt/torch_export.py` (the weights are the port's init carried to the
  JAX layout, AdaLN gates raised; the JAX VQVAE's eager init takes ~13 s
  here): `tokenize` ids bit for bit; `recon`, `sample` (joint, `--force
  control`, `--force image`) and `eval-cond` (both forces), greedy
  (`--top_k 1`) with fp32 compute on both sides (the JAX harness's class
  attribute and a port subclass patched in), write the same file names
  with pixels within 1 uint8 level, equal on >= 99.9%; `export` writes the
  same tensors.
- The port alone: the smoke runs of tests/test_cli.py (train, token shards,
  LoRA, train-var and its resume, train-vqvae --dual, bidirectional, the
  --var_pretrained surgery), the export of a train checkpoint, the JAX CLI's
  guards and messages, `--sampler sort` making no call of the bisection
  route, and the image subcommands exiting with a message that names PIL
  where PIL cannot be imported.

Every port call passes `--device cpu`; without it the CLI raises here
(tests/test_torch_port_rules.py)."""
import dataclasses
import glob
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from controlvar_tpu.ckpt import torch_export as jexport
from controlvar_tpu.cli import main as jcli
from controlvar_tpu.eval import harness as jharness

from controlvar_tpu_torch.ckpt.convert import to_jax_params
from controlvar_tpu_torch.ckpt.torch_export import export_var_state_dict, save_torch_checkpoint
from controlvar_tpu_torch.ckpt.torch_import import (convert_control_var_state_dict,
                                                    load_torch_state_dict)
from controlvar_tpu_torch.cli import main as tcli
from controlvar_tpu_torch.config import var_config_from_depth
from controlvar_tpu_torch.data import imagenetc
from controlvar_tpu_torch.eval import harness as tharness
from controlvar_tpu_torch.models.control_var import ControlVARModel
from controlvar_tpu_torch.models.var import VARModel
from controlvar_tpu_torch.models.vqvae import VQVAE
from controlvar_tpu_torch.ops import sampling as tsampling
from controlvar_tpu_torch.train.param_groups import named_leaves

SMOKE = ["--depth", "2", "--vae_ch", "32", "--patch_nums", "1", "2", "4", "--seed", "0"]
# the tokenizer subcommands read 256x256 images: the pyramid must end at 16
SMOKE_256 = ["--depth", "2", "--vae_ch", "32", "--patch_nums", "1", "2", "4", "8", "16"]
CPU = ["--device", "cpu"]
TRAIN = [*SMOKE, "--batch_size", "2", "--steps", "2", *CPU]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several test workers share the machine's cores: one torch thread
    each (torch's default pool of one a core oversubscribes them)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ---- the parser and the configs ----------------------------------------------


def _subcommands(parser):
    return parser._subparsers._group_actions[0].choices


def _options(parser):
    return {tuple(a.option_strings): (a.default, a.choices, a.nargs, a.type)
            for a in parser._actions if a.option_strings and a.dest != "help"}


JAX_SUBS = _subcommands(jcli.build_parser())


@pytest.mark.parametrize("name", sorted(JAX_SUBS))
def test_subcommand_options_equal_the_jax_cli(name):
    port = _subcommands(tcli.build_parser())
    assert set(port) == set(JAX_SUBS)
    got = _options(port[name])
    assert got.pop(("--device",)) == (None, None, None, str)
    assert got == _options(JAX_SUBS[name])


FLAG_SETS = [[], ["--bidirectional"], ["--separate_decoding"], ["--separator"],
             ["--type_pos"], ["--indep"], ["--uncond"], ["--drop_path_rate", "0.1"],
             ["--cond_drop_rate", "0.2"], ["--num_classes", "10"], ["--no-multi_cond"],
             ["--mask_type", "replace"], ["--uncond", "--cond_drop_rate", "0.3"],
             ["--depth", "30", "--vae_ch", "160"],
             ["--bidirectional", "--separate_decoding", "--separator", "--type_pos",
              "--indep", "--drop_path_rate", "0.1", "--cond_drop_rate", "0.2",
              "--num_classes", "10"]]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: " ".join(f) or "defaults")
def test_configs_equal_the_jax_cli(flags):
    argv = ["train", *SMOKE, *flags]
    jvq, jcfg = jcli._configs(jcli.build_parser().parse_args(argv))
    tvq, tcfg = tcli._configs(tcli.parse_args(argv))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jv = dataclasses.asdict(jvq)
    assert set(jv) - set(dataclasses.asdict(tvq)) == {"wpack_decoder"}  # not ported
    assert dataclasses.asdict(tvq) == {k: v for k, v in jv.items() if k != "wpack_decoder"}


def test_yaml_recipes_merge_as_in_the_jax_cli():
    """Every committed recipe merges into the same namespace as the JAX
    CLI's main merges it (tests/test_cli.py:58-85), explicit flags winning."""
    cfgs = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs", "*.yaml")))
    assert len(cfgs) >= 6
    for path in cfgs:
        argv = ["train", "--config", path, "--batch_size", "2"]
        want = jcli.build_parser().parse_args(argv)
        for k, v in jcli._load_yaml(path).items():
            if hasattr(want, k) and f"--{k}" not in argv and f"--no-{k}" not in argv:
                setattr(want, k, v)
        got = vars(tcli.parse_args(argv))
        assert got.pop("device") is None
        assert got == vars(want), path
        assert got["batch_size"] == 2 and got["depth"] in (12, 16, 20, 24, 30)


# ---- both CLIs on the same .pth files ----------------------------------------


def _raise_gates(tree):
    C = tree["blocks"]["ada_lin"]["bias"].shape[1] // 6
    tree["blocks"]["ada_lin"]["bias"][:, :C] += 10.0
    tree["blocks"]["ada_lin"]["bias"][:, C: 2 * C] += 1.0
    return tree


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
    """model.pth (ControlVAR depth 2 at patch_nums 1 2 4), vae.pth (the
    ch-32 VQVAE) written by the JAX exporter, and two condition images."""
    d = tmp_path_factory.mktemp("cli_files")
    jvq, jcfg = jcli._configs(jcli.build_parser().parse_args(["sample", *SMOKE]))
    tvq, tcfg = tcli._configs(tcli.parse_args(["sample", *SMOKE]))
    jp = _raise_gates(to_jax_params(ControlVARModel(tcfg, device="cpu").init_params(5), tcfg))
    jvp = _vq_to_jax(VQVAE(tvq, device="cpu").init_params(6))
    out = {"model": str(d / "model.pth"), "vae": str(d / "vae.pth")}
    jexport.save_torch_checkpoint(out["model"], jexport.export_control_var_state_dict(jp, jcfg))
    jexport.save_torch_checkpoint(out["vae"], jexport.export_vqvae_state_dict(jvp, jvq))
    rng = np.random.default_rng(0)
    for i, shape in enumerate([(80, 64, 3), (48, 72, 3)]):
        out[f"img{i}"] = str(d / f"cond{i}.png")
        Image.fromarray((rng.random(shape) * 255).astype(np.uint8)).save(out[f"img{i}"])
    return out


@dataclasses.dataclass
class _Fp32Harness(tharness.SamplingHarness):
    compute_dtype: torch.dtype = torch.float32


def _run_both(monkeypatch, tmp_path, argv):
    """Run argv through both CLIs (fp32 compute), each with its own --out;
    returns the two output paths (jax, port)."""
    monkeypatch.setattr(jharness.SamplingHarness, "compute_dtype", jnp.float32)
    monkeypatch.setattr(tharness, "SamplingHarness", _Fp32Harness)
    outs = []
    for name, main, extra in (("jax", jcli.main, []), ("port", tcli.main, CPU)):
        out = str(tmp_path / name) + (".npz" if argv[0] == "tokenize" else "")
        main([*argv, "--out", out, *extra])
        outs.append(out)
    return outs


def _pngs(root):
    out = {}
    for d, _, names in os.walk(root):
        for f in names:
            path = os.path.join(d, f)
            out[os.path.relpath(path, root)] = np.asarray(Image.open(path).convert("RGB"))
    return out


def _assert_same_pngs(got_root, want_root):
    got, want = _pngs(got_root), _pngs(want_root)
    assert got and sorted(got) == sorted(want)
    g = np.stack([got[k] for k in sorted(got)]).astype(np.int16)
    w = np.stack([want[k] for k in sorted(want)]).astype(np.int16)
    diff = np.abs(g - w)
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.999, (diff == 0).mean()
    return sorted(got)


def test_tokenize_ids_equal_the_jax_cli(files, tmp_path, monkeypatch):
    jax_out, port_out = _run_both(monkeypatch, tmp_path, [
        "tokenize", *SMOKE_256, "--vae_ckpt", files["vae"], "--images", files["img0"],
        files["img1"]])
    a, b = np.load(jax_out), np.load(port_out)
    assert sorted(a) == sorted(b) == [f"scale_{i}" for i in range(5)]
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(b[k], a[k])


GEN_CASES = {
    "recon": ["recon", *SMOKE_256, "--images", "{img0}", "{img1}"],
    "sample-joint": ["sample", *SMOKE, "--batch_size", "2", "--top_k", "1",
                     "--classes", "3", "7"],
    "sample-control": ["sample", *SMOKE, "--batch_size", "3", "--top_k", "1", "--force",
                       "control", "--cond_image", "{img0}", "{img1}", "--cond_type", "mask"],
    "sample-image": ["sample", *SMOKE, "--batch_size", "2", "--top_k", "1", "--force", "image",
                     "--cond_image", "{img1}"],
    "eval-cond-control": ["eval-cond", *SMOKE, "--batch_size", "2", "--max_batches", "2",
                          "--top_k", "1"],
    "eval-cond-image": ["eval-cond", *SMOKE, "--batch_size", "3", "--max_batches", "1",
                        "--top_k", "1", "--force", "image", "--val_cond", "mask",
                        "--decode_both"],
}
GEN_FILES = {
    "recon": ["recon_0.png", "recon_1.png"],
    "sample-joint": ["sample_0_cls3.png", "sample_1_cls7.png"],
    "sample-control": [f"cfg_4_4_4_mask/sample_{b}_cls{b}.png" for b in range(3)],
    "sample-image": [f"cfg_4_4_4_depth/sample_{b}_cls{b}.png" for b in range(2)],
    "eval-cond-control": [f"cfg_6_6_6_depth/0/{i}.png" for i in range(4)],
    "eval-cond-image": [f"cfg_6_6_6_mask/0/{i}.png" for i in range(3)],
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generation_outputs_equal_the_jax_cli(case, files, tmp_path, monkeypatch):
    argv = [a.format(**files) for a in GEN_CASES[case]]
    argv += ["--ckpt", files["model"], "--vae_ckpt", files["vae"]]
    jax_out, port_out = _run_both(monkeypatch, tmp_path, argv)
    names = _assert_same_pngs(port_out, jax_out)
    assert names == sorted(GEN_FILES[case])


@pytest.mark.parametrize("what", ["model", "vqvae"])
def test_export_writes_the_jax_cli_tensors(what, files, tmp_path, monkeypatch):
    jax_out, port_out = _run_both(monkeypatch, tmp_path, [
        "export", *SMOKE, "--what", what, "--ckpt", files["model"], "--vae_ckpt", files["vae"]])
    a, b = torch.load(jax_out, weights_only=False), torch.load(port_out, weights_only=False)
    assert (a["step"], a["epoch"]) == (b["step"], b["epoch"]) == (0, 0)
    a, b = a["model_state_dict"], b["model_state_dict"]
    assert sorted(a) == sorted(b)
    for k in a:
        assert b[k].dtype == torch.float32 and torch.equal(b[k], torch.as_tensor(a[k])), k


# ---- the port alone ----------------------------------------------------------


def test_cli_train_smoke(capsys):
    tcli.main(["train", *TRAIN, "--data", "synthetic", "--epochs", "1", "--grad_accum", "2"])
    assert "loss=" in capsys.readouterr().out


@dataclasses.dataclass
class _ShortSynthetic(imagenetc.SyntheticControlDataset):
    length: int = 8


def test_cli_train_token_shards_smoke(tmp_path, capsys, monkeypatch):
    """pretokenize -> train --token_shards: the pre-tokenized path. The CLI
    has no flag for the length of the synthetic split (nor has the JAX
    one): the test shortens it from 10,000 samples to 8, four shards."""
    monkeypatch.setattr(imagenetc, "SyntheticControlDataset", _ShortSynthetic)
    out_dir = str(tmp_path / "tok")
    tcli.main(["pretokenize", *SMOKE, *CPU, "--batch_size", "2", "--data", "synthetic",
               "--out", out_dir])
    assert "wrote 4 token shards" in capsys.readouterr().out
    tcli.main(["train", *TRAIN, "--token_shards", f"{out_dir}/*.npz", "--epochs", "1",
               "--log_every", "1"])
    assert "loss=" in capsys.readouterr().out
    with pytest.raises(ValueError, match="bidirectional"):
        tcli.main(["train", *TRAIN, "--token_shards", f"{out_dir}/*.npz", "--bidirectional"])


def test_cli_train_lora_and_export_merge(tmp_path, capsys, files):
    """LoRA fine-tune from a .pth base: only the (A, B) factors train; the
    export of its checkpoint merges them into the base."""
    ck = str(tmp_path / "ck")
    tcli.main(["train", *TRAIN, "--data", "synthetic", "--epochs", "1", "--lora", "4",
               "--ckpt", files["model"], "--ckpt_dir", ck])
    assert "loss=" in capsys.readouterr().out
    out = str(tmp_path / "merged.pth")
    tcli.main(["export", *SMOKE, *CPU, "--ckpt_dir", ck, "--ckpt", files["model"],
               "--out", out])
    assert "merged LoRA rank-4 factors" in capsys.readouterr().out
    base = load_torch_state_dict(files["model"])
    merged = load_torch_state_dict(out)
    assert sorted(base) == sorted(merged)
    moved = [k for k in base if not torch.equal(base[k], merged[k])]
    assert moved and all(".ffn." in k or ".ada_lin." in k or ".attn.proj." in k for k in moved)


def test_cli_train_checkpoint_export_round_trip(tmp_path, capsys):
    """train --ckpt_dir, then export --ckpt_dir: the exported .pth imports
    back to the checkpoint's params bit for bit."""
    ck = str(tmp_path / "ck")
    tcli.main(["train", *TRAIN, "--data", "synthetic", "--epochs", "1", "--ckpt_dir", ck])
    out = str(tmp_path / "e.pth")
    tcli.main(["export", *SMOKE, *CPU, "--ckpt_dir", ck, "--out", out])
    assert "step=2" in capsys.readouterr().out
    from controlvar_tpu_torch.ckpt.orbax_io import CheckpointIO

    state, _ = CheckpointIO(ck).restore_raw()
    cfg = tcli._configs(tcli.parse_args(["export", *SMOKE]))[1]
    back = convert_control_var_state_dict(load_torch_state_dict(out), cfg, device="cpu")
    want = dict(named_leaves(state["params"]))
    got = dict(named_leaves(back))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_cli_train_var_smoke_and_resume(tmp_path, capsys):
    run = ["train-var", *SMOKE, *CPU, "--batch_size", "2", "--data", "synthetic",
           "--epochs", "1", "--ckpt_dir", str(tmp_path / "ck")]
    tcli.main([*run, "--steps", "2"])
    assert "loss=" in capsys.readouterr().out
    tcli.main([*run, "--steps", "3"])
    assert "resumed train-var at step 2" in capsys.readouterr().out


def test_cli_train_vqvae_dual_resume_and_export(tmp_path, capsys):
    """Dual-codebook MaskVQVAE training, its resume, and the export of its
    checkpoint (the MaskVQVAE layout)."""
    run = ["train-vqvae", *SMOKE, *CPU, "--batch_size", "2", "--data", "synthetic",
           "--epochs", "1", "--dual", "--ckpt_dir", str(tmp_path / "ck")]
    tcli.main([*run, "--steps", "1"])
    out = capsys.readouterr().out
    assert "nll=" in out and "usage=" in out
    tcli.main([*run, "--steps", "2"])
    assert "resumed train-vqvae at step 1" in capsys.readouterr().out
    pth = str(tmp_path / "q.pth")
    tcli.main(["export", *SMOKE, *CPU, "--what", "vqvae", "--ckpt_dir", str(tmp_path / "ck"),
               "--out", pth])
    sd = load_torch_state_dict(pth)
    assert "mask_quantize.embedding.weight" in sd and "filter.weight" in sd
    ck = str(tmp_path / "ck2")
    tcli.main(["train", *TRAIN, "--data", "synthetic", "--epochs", "1", "--ckpt_dir", ck])
    with pytest.raises(SystemExit, match="no vq_params"):
        tcli.main(["export", *SMOKE, *CPU, "--what", "vqvae", "--ckpt_dir", ck])


def test_cli_train_bidirectional_smoke(capsys):
    tcli.main(["train", *TRAIN, "--data", "synthetic", "--epochs", "1", "--bidirectional",
               "--type_pos"])
    assert "loss=" in capsys.readouterr().out


def test_cli_train_var_pretrained_surgery_smoke(tmp_path, capsys):
    """train --var_pretrained x.pth --interpos --mpos: .pth import -> VAR ->
    ControlVAR surgery -> train (the VAR .pth written by the port's
    exporter)."""
    var_cfg = var_config_from_depth(2, patch_nums=(1, 2, 4))
    pth = str(tmp_path / "var_d2.pth")
    save_torch_checkpoint(pth, export_var_state_dict(
        VARModel(var_cfg, device="cpu").init_params(3), var_cfg))
    tcli.main(["train", *TRAIN, "--data", "synthetic", "--epochs", "1",
               "--var_pretrained", pth, "--interpos", "--mpos", "--separator"])
    assert "loss=" in capsys.readouterr().out


def test_cli_guards_and_messages(tmp_path):
    """The JAX CLI's guards: --force without --cond_image, an empty
    --ckpt_dir, a model axis larger than the process group (one process
    here; tests/test_torch_tp.py runs it on two), and the samplers'
    separator/type_pos rejection, surfaced as they are."""
    with pytest.raises(SystemExit, match="--force control requires --cond_image"):
        tcli.main(["sample", *SMOKE, *CPU, "--force", "control"])
    with pytest.raises(SystemExit, match="no checkpoint found under"):
        tcli.main(["export", *SMOKE, *CPU, "--ckpt_dir", str(tmp_path / "empty")])
    with pytest.raises(ValueError, match="needs 2 processes, have 1"):
        tcli.main(["train", *TRAIN, "--model_axis", "2"])
    with pytest.raises(ValueError, match="separator/type_pos"):
        tcli.main(["sample", *SMOKE, *CPU, "--separator", "--out", str(tmp_path / "s")])


@pytest.mark.parametrize("sampler,expect_k2", [("sort", False), (None, True)])
def test_sampler_flag_routes_every_draw(sampler, expect_k2, tmp_path, monkeypatch, capsys):
    """--sampler sort: no draw of sample, eval-cond or fid goes through the
    bisection route (K2 on the card); without the flag every one does."""
    calls = []
    orig = tsampling.sample_top_k_top_p_bisect
    monkeypatch.setattr(tsampling, "sample_top_k_top_p_bisect",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    flag = ["--sampler", sampler] if sampler else []
    for argv in (["sample", "--batch_size", "2"],
                 ["eval-cond", "--batch_size", "2", "--max_batches", "1"],
                 ["fid", "--batch_size", "2", "--images_per_class", "2",
                  "--gen_classes", "1"]):
        calls.clear()
        tcli.main([*argv, *SMOKE, *CPU, *flag, "--out", str(tmp_path / argv[0])])
        assert len(calls) == (3 if expect_k2 else 0), argv[0]
    assert "wrote 2 images" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["tokenize", "--images", "x.png"],
    ["recon", "--images", "x.png"],
    ["sample", "--force", "control", "--cond_image", "x.png"],
], ids=lambda a: a[0])
def test_image_subcommands_name_pil_without_it(argv, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(SystemExit, match="PIL"):
        tcli.main([*argv, *SMOKE_256, *CPU])
