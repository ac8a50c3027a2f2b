"""A cell of BENCHMARK.json at a size the CPU runs in seconds: the
configuration cut to depth 2, width 128, 10 classes, V 64, patch_nums
(1, 2, 4), a ch-32 VQVAE on 64x64 images; batches of at most 2."""
from __future__ import annotations

import copy

import pytest
import torch

from cvbench import spec


def tiny_cell(workload: str):
    cell = copy.deepcopy(spec.load_cell(workload))
    cell.config["model"].update(depth=2, embed_dim=128, num_heads=2, num_classes=10,
                                vocab_size=64, patch_nums=[1, 2, 4])
    cell.config["vqvae"].update(vocab_size=64, ch=32, patch_nums=[1, 2, 4], image_size=64)
    t = cell.traffic
    t["batch"] = min(t["batch"], 2)
    for key, n in (("input_sets", 2), ("trace_units", 4)):
        if key in t:
            t[key] = n
    return cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
