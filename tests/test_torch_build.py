"""The kernel build's cache key: a library is rebuilt when its source, a
header beside it or the flags change, and only then. Hashing only; no
nvcc is needed."""
import pytest

from controlvar_tpu_torch.ops import _build

from tests.torch_fixtures import one_torch_thread  # noqa: F401


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "common.cuh"\nint a() { return helper(); }\n')
    (tmp_path / "common.cuh").write_text("inline int helper() { return 1; }\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    return tmp_path


def test_target_is_stable(csrc):
    assert _build._target("a") == _build._target("a")
    assert _build._target("a").startswith(_build.BUILD_DIR)


@pytest.mark.parametrize("change", ["header", "source", "new header", "flags"])
def test_target_changes_with_what_the_build_reads(csrc, monkeypatch, change):
    before = _build._target("a")
    if change == "header":
        (csrc / "common.cuh").write_text("inline int helper() { return 2; }\n")
    elif change == "source":
        (csrc / "a.cu").write_text('#include "common.cuh"\nint a() { return -helper(); }\n')
    elif change == "new header":
        (csrc / "other.cuh").write_text("#pragma once\n")
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._target("a") != before


def test_target_ignores_other_sources(csrc):
    before = _build._target("a")
    (csrc / "b.cu").write_text("int b() { return 3; }\n")
    assert _build._target("a") == before
