"""Build and load the port's CUDA kernels.

Each `controlvar_tpu_torch/csrc/<name>.cu` is compiled by `nvcc` for Hopper
(`sm_90a`) into its own shared library with a plain C interface, under
`build/kernels/` at the repository root, at first use. A library is cached by
a hash of its source and of the headers beside it (`csrc/*.cuh`), so an
unchanged kernel is not rebuilt and a changed header rebuilds every source.
The sources of a build are compiled together, one `nvcc` process each.
Libraries are loaded with ctypes: every pointer and the stream are passed as
`c_void_p`, and every C entry returns `cudaGetLastError()`, which `check`
turns into an exception.

A failed build raises: nothing falls back to another path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                           "CUDA toolkit")
    return path


def _target(name: str) -> str:
    """The library path of csrc/<name>.cu: a hash of the source, of every
    header in csrc/ (which a source may include) and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read() + b"\0")
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources that have no cached library, all at once.
    Returns {name: ptxas report} for the sources compiled by this call."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if os.path.exists(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    reports = {}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        os.replace(tmp, target)
        reports[name] = out
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(_target(name))
        return lib


def entry(lib: str, name: str, argtypes):
    """The C entry `name` of csrc/<lib>.cu, built and typed at first use;
    it returns a cudaError_t (`check`)."""
    fn = getattr(load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str, detail: Optional[str] = None) -> None:
    """Raise if a C entry returned a non-zero cudaError_t."""
    if err != 0:
        msg = f"{what}: CUDA error {err}"
        if detail:
            msg += f" ({detail})"
        raise RuntimeError(msg)
