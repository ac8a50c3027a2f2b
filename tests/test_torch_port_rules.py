"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
PIL and cv2 only inside functions of `controlvar_tpu_torch/data/` (the
card's machine has neither: it runs synthetic batches or token shards),
the upstream reference's `models` package only inside functions of
`eval/parity.py` (imported from a checkout at call time, never shipped),
its entry points default to CUDA and raise without it, the host-only data
classes take no device, and its kernel wrappers take their plain versions
only for CPU tensors."""
import ast
import pathlib

import pytest
import torch

from tests.torch_fixtures import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "controlvar_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax", "controlvar_tpu"), (
            f"{path.relative_to(ROOT)} imports {mod}")


def _image_imports(path):
    """(module-level?, module) of every PIL or cv2 import of a file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                 [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
        for name in names:
            if name.split(".")[0] in ("PIL", "cv2"):
                yield id(node) in top, name


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_pil_and_cv2_only_inside_functions_of_the_data_layer(path):
    """A module-level PIL or cv2 import anywhere in the port fails on the
    card's machine at import; one inside a function is allowed in
    controlvar_tpu_torch/data/ only, where the file-backed datasets decode."""
    in_data = path.parent == ROOT / "controlvar_tpu_torch" / "data"
    for module_level, name in _image_imports(path):
        assert not module_level, f"{path.relative_to(ROOT)} imports {name} at module level"
        assert in_data, f"{path.relative_to(ROOT)} imports {name} outside data/"


def test_pil_rule_sees_the_imports_it_forbids(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import PIL.Image\nfrom cv2 import imread\n\n"
                   "def f():\n    from PIL import Image\n")
    assert list(_image_imports(bad)) == [(True, "PIL.Image"), (True, "cv2"), (False, "PIL")]
    data = ROOT / "controlvar_tpu_torch" / "data"
    assert any(not top for p in data.glob("*.py") for top, _ in _image_imports(p))


def _reference_imports(path):
    """(module-level?, function name or None, module) of every import of
    the upstream reference's top-level `models` package in a file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    owner = {}
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for node in ast.walk(fn):
                owner.setdefault(id(node), fn.name)
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                 [node.module] if isinstance(node, ast.ImportFrom) and node.module
                 and node.level == 0 else [])
        for name in names:
            if name.split(".")[0] == "models":
                yield id(node) in top, owner.get(id(node)), name


PARITY = ROOT / "controlvar_tpu_torch" / "eval" / "parity.py"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_models_only_inside_functions_of_parity(path):
    """The upstream reference's `models.*` is imported at call time from
    its checkout, inside the functions of eval/parity.py only: anywhere
    else it would shadow nothing the port has and fail without the
    checkout."""
    for module_level, fn, name in _reference_imports(path):
        assert not module_level and fn is not None, (
            f"{path.relative_to(ROOT)} imports {name} outside a function")
        assert path == PARITY, f"{path.relative_to(ROOT)} imports {name} outside eval/parity.py"


def test_reference_rule_sees_the_imports_it_forbids(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import models.vqvae\nfrom models.control_var import ControlVAR\n"
                   "from controlvar_tpu_torch.models import vqvae\n\n"
                   "def f():\n    from models.vqvae import VQVAE\n")
    assert list(_reference_imports(bad)) == [(True, None, "models.vqvae"),
                                             (True, None, "models.control_var"),
                                             (False, "f", "models.vqvae")]
    found = list(_reference_imports(PARITY))
    assert {name for _, _, name in found} == {"models.vqvae", "models.control_var"}
    assert {fn for _, fn, _ in found} == {"token_stream_parity", "logits_parity"}


def test_port_has_sources_and_kernels():
    assert len(PORT_FILES) > 10
    assert sorted(p.name for p in (ROOT / "controlvar_tpu_torch" / "csrc").glob("*.cu")) == [
        "adaln.cu", "decode_attention.cu", "decode_flat.cu", "decode_prefix.cu",
        "flash_attention.cu", "sample_bisect.cu"]
    assert (ROOT / "controlvar_tpu_torch" / "native" / "rle_native.c").exists()
    assert {"build.py", "shards.py", "imagenetc.py", "datasets_extra.py", "rle.py",
            "colormap.py", "transforms.py"} <= {
        p.name for p in (ROOT / "controlvar_tpu_torch" / "data").glob("*.py")}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda_and_device(no_cuda):
    from controlvar_tpu_torch.ckpt.convert import from_jax_params
    from controlvar_tpu_torch.config import ControlVARConfig, VQVAEConfig
    from controlvar_tpu_torch.eval.harness import SamplingHarness
    from controlvar_tpu_torch.config import VARConfig
    from controlvar_tpu_torch.eval.stepwise import (StepwiseCondSampler, StepwiseJointSampler,
                                                    StepwiseVARSampler)
    from controlvar_tpu_torch.models import class_embedder
    from controlvar_tpu_torch.models.control_var import ControlVARModel
    from controlvar_tpu_torch.models.var import VARModel
    from controlvar_tpu_torch.models.vqvae import VQVAE

    cfg = ControlVARConfig(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2),
                           vocab_size=64, multi_cond=True)
    vq_cfg = VQVAEConfig(ch=32, patch_nums=(1, 2), vocab_size=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        ControlVARModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        VQVAE(vq_cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_params({}, vq_cfg)
    model, vqvae = ControlVARModel(cfg, device="cpu"), VQVAE(vq_cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        SamplingHarness(model, vqvae)
    with pytest.raises(RuntimeError, match="CUDA"):
        StepwiseCondSampler(model, vqvae)
    with pytest.raises(RuntimeError, match="CUDA"):
        StepwiseJointSampler(model, vqvae)
    assert SamplingHarness(model, vqvae, device="cpu").device == torch.device("cpu")
    var_cfg = VARConfig(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2), vocab_size=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        VARModel(var_cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        StepwiseVARSampler(VARModel(var_cfg, device="cpu"), vqvae)
    with pytest.raises(RuntimeError, match="CUDA"):
        class_embedder.init_params(torch.Generator(), 10, 8)
    from controlvar_tpu_torch.ckpt import torch_import
    from controlvar_tpu_torch.ckpt.lora import LoRAConfig
    from controlvar_tpu_torch.config import OptimConfig
    from controlvar_tpu_torch.train.train_step import (ControlVARTrainStep,
                                                       LoRAControlVARTrainStep, VARTrainStep)

    with pytest.raises(RuntimeError, match="CUDA"):
        VARTrainStep(VARModel(var_cfg, device="cpu"), vqvae, OptimConfig(), 10, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        LoRAControlVARTrainStep(ControlVARTrainStep(model, vqvae, OptimConfig(), 10, 1),
                                LoRAConfig())
    for convert, conv_cfg in ((torch_import.convert_vqvae_state_dict, vq_cfg),
                              (torch_import.convert_var_state_dict, var_cfg),
                              (torch_import.convert_control_var_state_dict, cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            convert({}, conv_cfg)
    # the models of every option: no option raises on the CPU any more
    opts = ControlVARConfig(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2),
                            vocab_size=64, multi_cond=True, separator=True, type_pos=True,
                            shared_aln=True, bidirectional=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        ControlVARModel(opts)
    with pytest.raises(RuntimeError, match="CUDA"):
        VARModel(VARConfig(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2),
                           vocab_size=64, shared_aln=True))
    ControlVARModel(opts, device="cpu").init_params(0)


def test_host_data_classes_take_no_device(no_cuda, tmp_path):
    """The loader, the synthetic dataset and the token shards run without
    CUDA and without a device; pretokenize runs on its VQVAE's device."""
    import numpy as np

    from controlvar_tpu_torch.config import VQVAEConfig
    from controlvar_tpu_torch.data.build import Loader, create_dataset, to_device
    from controlvar_tpu_torch.data.shards import (TokenShardLoader, pretokenize,
                                                  read_token_shard)
    from controlvar_tpu_torch.models.vqvae import VQVAE

    ds = create_dataset("synthetic", image_size=32, patch_nums=(1, 2), length=4,
                        separator=True)
    batch = next(iter(Loader(ds, batch_size=2, num_workers=1).epoch(0)))
    assert to_device(batch, "cpu")["image"].device.type == "cpu"
    vqvae = VQVAE(VQVAEConfig(ch=32, patch_nums=(1, 2), vocab_size=64), device="cpu")
    n = pretokenize(vqvae, vqvae.init_params(0), Loader(ds, batch_size=2, num_workers=1),
                    str(tmp_path), compute_dtype=torch.float32)
    loader = TokenShardLoader(str(tmp_path / "tokens_*.npz"))
    assert n == loader.steps_per_epoch() == 2
    shard = next(iter(loader.epoch(0)))
    assert shard["ctrl_ids"][1].shape == (2, 4) and shard["ignore_mask"].shape == (2, 12)
    assert np.array_equal(read_token_shard(loader.paths[0])["cls"].shape, (2,))


def test_kernel_wrappers_reject_other_devices():
    from controlvar_tpu_torch.ops.attention import (decode_attention,
                                                    decode_attention_inplace,
                                                    decode_attention_prefix)
    from controlvar_tpu_torch.ops.sample_kernel import sample_top_k_top_p_bisect

    q = torch.zeros(1, 2, 3, 64, device="meta")
    cache = torch.zeros(1, 1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(q, cache, cache, 0, 3, 0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention_prefix(q, cache[0], cache[0], q, q, 0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention_inplace(q, cache, cache, q, q, 0, 2, 0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        sample_top_k_top_p_bisect(torch.zeros(2, 64, device="meta"), 8, 0.9)


def test_kernel_sources_name_the_tpu_kernel_they_replace():
    csrc = ROOT / "controlvar_tpu_torch" / "csrc"
    assert "ops/attention.py:flash_decode_paired" in (csrc / "decode_attention.cu").read_text()
    assert "ops/sample_kernel.py:" in (csrc / "sample_bisect.cu").read_text()
    assert "ops/attention.py:flash_decode_fused" in (csrc / "decode_attention.cu").read_text()
    assert "ops/attention.py:flash_decode\n" in (csrc / "decode_flat.cu").read_text()
    prefix = (csrc / "decode_prefix.cu").read_text()
    for name in ("flash_decode_prefix", "_prefix_kernel_paired", "flash_decode_inplace",
                 "_inplace_kernel"):
        assert name in prefix
    for name in ("ops/attention.py:flash_decode_prefix", "_prefix_kernel_paired"):
        assert name in (csrc / "decode_attention.cu").read_text()  # K5 runs K1's kernel
    flash = (csrc / "flash_attention.cu").read_text()
    for name in ("ops/attention.py:flash_attention", "_flash_kernel",
                 "ops/attention.py:flash_attention_bwd", "_flash_bwd_dq_kernel",
                 "_flash_bwd_dkv_kernel"):
        assert name in flash


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("symbol,category", [
    ("void (anonymous namespace)::decode_attention_prefix_kernel<2>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::Rows, "
     "unsigned char const*, __nv_bfloat16*, int, int, int, int, int, float)", "K5 prefix decode"),
    ("void (anonymous namespace)::decode_attention_kernel<false, 2>(CUtensorMap_st, "
     "CUtensorMap_st, (anonymous namespace)::Rows, unsigned char const*, __nv_bfloat16*, int, "
     "int, int, int, int, float)", "K1/K8 decode attention"),
    ("void (anonymous namespace)::decode_attention_kernel<true, 1>(...)",
     "K1/K8 decode attention"),
    ("void inplace::decode_inplace_kernel<2>(...)", "K6 in-place decode"),
    ("void (anonymous namespace)::decode_flat_kernel<64, 2>(...)", "K7 flat decode attention"),
    ("bwd::flash_bwd_dq_kernel(...)", "K4 flash attention backward"),
    ("bwd::flash_bwd_dkv_kernel(...)", "K4 flash attention backward"),
    ("(anonymous namespace)::flash_fwd_kernel(...)", "K3 flash attention"),
])
def test_profile_categories_tell_the_kernels_apart(symbol, category):
    """chip_smoke's device-time categories: K5 runs K1's kernel body under a
    name of its own, which must not fall into K1/K8's category."""
    assert _chip_smoke().category(symbol) == category


def test_training_slice_modules_exist_and_stay_free_of_wandb_and_pil_at_import():
    """The trainer and tokenizer-training slice is in the port under the JAX
    package's names; the Tracker imports wandb only inside a function (the
    card's machine has none), and no module of the slice imports PIL: PNGs
    are written with the standard library's zlib."""
    pkg = ROOT / "controlvar_tpu_torch"
    names = ["utils/misc.py", "utils/tracker.py", "parallel/distributed.py", "parallel/mesh.py",
             "train/trainer.py", "train/train_vqvae.py", "models/vqvae_mask.py",
             "losses/lpips.py", "losses/discriminator.py", "losses/vqperceptual.py",
             "losses/segmentation.py"]
    for name in names:
        assert (pkg / name).exists(), name
        assert (ROOT / "controlvar_tpu" / name).exists(), name
        assert not list(_image_imports(pkg / name)), name
    tree = ast.parse((pkg / "utils" / "tracker.py").read_text())
    top = {id(n) for n in tree.body}
    wandb = [n for n in ast.walk(tree) if isinstance(n, ast.Import)
             and any(a.name.split(".")[0] == "wandb" for a in n.names)]
    assert wandb and not any(id(n) in top for n in wandb)
    from controlvar_tpu_torch.config import MeshConfig  # noqa: F401


def test_training_slice_entry_points_raise_without_cuda_and_device(no_cuda, tmp_path,
                                                                   monkeypatch):
    from controlvar_tpu_torch.config import ControlVARConfig, OptimConfig, VQVAEConfig
    from controlvar_tpu_torch.data.shards import TokenShardLoader, write_token_shard
    from controlvar_tpu_torch.losses.lpips import convert_lpips_state_dict
    from controlvar_tpu_torch.models.vqvae_mask import MaskVQVAE
    from controlvar_tpu_torch.parallel import distributed
    from controlvar_tpu_torch.train.trainer import Trainer

    import numpy as np

    cfg = ControlVARConfig(depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2),
                           vocab_size=64, multi_cond=True)
    vq_cfg = VQVAEConfig(ch=32, patch_nums=(1, 2), vocab_size=64)
    ids = [np.zeros((2, 1), np.int64), np.zeros((2, 4), np.int64)]
    write_token_shard(str(tmp_path / "tokens_00000.npz"), ids, ids, np.zeros(2), np.zeros(2))
    loader = TokenShardLoader(str(tmp_path / "tokens_*.npz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, vq_cfg, OptimConfig(), loader, {}, from_tokens=True)
    assert Trainer(cfg, vq_cfg, OptimConfig(), loader, {}, from_tokens=True,
                   device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        MaskVQVAE(vq_cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert_lpips_state_dict({})
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1")
    monkeypatch.setenv("NUM_PROCESSES", "1")
    monkeypatch.setenv("PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.initialize()


def test_cli_raises_without_cuda_and_device_and_runs_with_device_cpu(no_cuda, tmp_path,
                                                                     capsys):
    """The CLI is an entry point: without --device and without a GPU every
    subcommand raises before any work; --device cpu runs it (the image
    subcommands and the evaluation layer are in the port, PIL-free at
    import)."""
    from controlvar_tpu_torch.cli.main import COMMANDS, main

    smoke = ["--depth", "2", "--vae_ch", "32", "--patch_nums", "1", "2", "4"]
    for cmd in COMMANDS:
        with pytest.raises(RuntimeError, match="CUDA"):
            main([cmd, *smoke, "--out", str(tmp_path / cmd)] if cmd not in (
                "train", "train-var", "train-vqvae") else [cmd, *smoke])
    assert not list(tmp_path.iterdir())
    main(["sample", *smoke, "--batch_size", "1", "--device", "cpu",
          "--out", str(tmp_path / "s")])
    assert "wrote 1 samples" in capsys.readouterr().out
    for name in ("cli/main.py", "eval/serving.py", "eval/harness.py"):
        path = ROOT / "controlvar_tpu_torch" / name
        assert path in PORT_FILES and not list(_image_imports(path)), name
