"""The port's `ckpt/download.py`: the five cases of tests/test_download.py on
the port's own copy of the module (cache hit, md5 recheck of a stale cache,
a download with its md5 gate, the offline error, an unknown name), with
local files and file:// URLs only."""
import hashlib
import os

import pytest

from controlvar_tpu_torch.ckpt.download import CKPT_MAP, MD5_MAP, URL_MAP, get_ckpt_path, md5_hash

from tests.torch_fixtures import one_torch_thread  # noqa: F401


def test_cache_hit_returns_without_download(tmp_path, monkeypatch):
    p = tmp_path / CKPT_MAP["vgg_lpips"]
    p.write_bytes(b"cached")
    # a cache hit reads no URL (check=False skips the md5 too)
    monkeypatch.setitem(URL_MAP, "vgg_lpips", (tmp_path / "absent.bin").as_uri())
    assert get_ckpt_path("vgg_lpips", str(tmp_path)) == str(p)


def test_md5_recheck_flags_stale_cache(tmp_path, monkeypatch):
    p = tmp_path / CKPT_MAP["vgg_lpips"]
    p.write_bytes(b"corrupted")
    good = b"the real weights"
    src = tmp_path / "src.bin"
    src.write_bytes(good)
    monkeypatch.setitem(URL_MAP, "vgg_lpips", src.as_uri())
    monkeypatch.setitem(MD5_MAP, "vgg_lpips", hashlib.md5(good).hexdigest())
    out = get_ckpt_path("vgg_lpips", str(tmp_path), check=True)
    assert open(out, "rb").read() == good


def test_download_via_file_url_and_md5_gate(tmp_path, monkeypatch):
    good = b"released checkpoint bytes"
    src = tmp_path / "remote.pth"
    src.write_bytes(good)
    monkeypatch.setitem(URL_MAP, "controlvar_d16", src.as_uri())
    out = get_ckpt_path("controlvar_d16", str(tmp_path / "cache"))
    assert os.path.basename(out) == "d16.pth"
    assert md5_hash(out) == hashlib.md5(good).hexdigest()
    assert not os.path.exists(out + ".part")
    # an md5 mismatch raises rather than returning corrupt weights
    monkeypatch.setitem(MD5_MAP, "controlvar_d16", "0" * 32)
    os.remove(out)
    with pytest.raises(RuntimeError, match="md5 mismatch"):
        get_ckpt_path("controlvar_d16", str(tmp_path / "cache"))


def test_offline_error_is_actionable(tmp_path, monkeypatch):
    """A URL that cannot be read (here a file:// URL of a missing file)
    raises an error that says what to do, and leaves no partial file."""
    monkeypatch.setitem(URL_MAP, "vgg_lpips", (tmp_path / "missing.bin").as_uri())
    with pytest.raises(RuntimeError, match="no network"):
        get_ckpt_path("vgg_lpips", str(tmp_path / "cache"))
    assert not os.listdir(tmp_path / "cache")


def test_unknown_name(tmp_path):
    with pytest.raises(KeyError):
        get_ckpt_path("nope", str(tmp_path))
