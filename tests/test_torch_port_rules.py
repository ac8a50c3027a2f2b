"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points default to CUDA and raise without it, and its kernel
wrappers take their plain versions only for CPU tensors."""
import ast
import pathlib

import pytest
import torch

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


def test_port_has_sources_and_kernels():
    assert len(PORT_FILES) > 10
    assert sorted(p.name for p in (ROOT / "controlvar_tpu_torch" / "csrc").glob("*.cu")) == [
        "decode_attention.cu", "flash_attention.cu", "sample_bisect.cu"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda_and_device(no_cuda):
    from controlvar_tpu_torch.ckpt.convert import from_jax_params
    from controlvar_tpu_torch.config import ControlVARConfig, VQVAEConfig
    from controlvar_tpu_torch.eval.harness import SamplingHarness
    from controlvar_tpu_torch.eval.stepwise import StepwiseCondSampler
    from controlvar_tpu_torch.models.control_var import ControlVARModel
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
    assert SamplingHarness(model, vqvae, device="cpu").device == torch.device("cpu")


def test_kernel_wrappers_reject_other_devices():
    from controlvar_tpu_torch.ops.attention import decode_attention
    from controlvar_tpu_torch.ops.sample_kernel import sample_top_k_top_p_bisect

    q = torch.zeros(1, 2, 3, 64, device="meta")
    cache = torch.zeros(1, 1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        decode_attention(q, cache, cache, 0, 3, 0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        sample_top_k_top_p_bisect(torch.zeros(2, 64, device="meta"), 8, 0.9)


def test_kernel_sources_name_the_tpu_kernel_they_replace():
    csrc = ROOT / "controlvar_tpu_torch" / "csrc"
    assert "ops/attention.py:flash_decode_paired" in (csrc / "decode_attention.cu").read_text()
    assert "ops/sample_kernel.py:" in (csrc / "sample_bisect.cu").read_text()
    flash = (csrc / "flash_attention.cu").read_text()
    for name in ("ops/attention.py:flash_attention", "_flash_kernel",
                 "ops/attention.py:flash_attention_bwd", "_flash_bwd_dq_kernel",
                 "_flash_bwd_dkv_kernel"):
        assert name in flash
