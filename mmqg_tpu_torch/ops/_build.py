"""Build the package's CUDA kernels into one shared library and load it.

The sources under ``mmqg_tpu_torch/csrc/`` have a plain C interface, so they
compile with ``nvcc`` alone (seconds) into ``libmmqg_kernels.so`` and load
with ``ctypes`` -- no PyTorch headers, no extension build. The library goes
under ``mmqg_tpu_torch/build/<hash of the sources and flags>/`` at first
use, so an edited source rebuilds and an unchanged one is reused. There is
no fallback: without ``nvcc`` the build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points and their argument types: every pointer and the stream are
# c_void_p (a bare Python int would be cut to 32 bits), every int is c_int.
SIGNATURES = {
    "mmqg_lstm_seq": [_P] * 11 + [_I] * 5 + [_P],
    "mmqg_trimodal_attention": [_P] * 13 + [_I] * 8 + [_P],
}


class Build(NamedTuple):
    path: Path        # the shared library
    seconds: float    # time nvcc took (0.0 when a built library was reused)
    log: str          # nvcc's output, ptxas register and spill report included


_loaded: Optional[ctypes.CDLL] = None
_build: Optional[Build] = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
        "mmqg_tpu_torch are built from source and have no fallback")


def build() -> Build:
    """Compile the kernels unless a library for these exact sources exists."""
    global _build
    if _build is not None:
        return _build
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_DIR / digest.hexdigest()[:16]
    lib = out_dir / "libmmqg_kernels.so"
    if lib.exists():
        _build = Build(lib, 0.0, "")
        return _build
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in sorted(CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *cu],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    _build = Build(lib, seconds, log)
    return _build


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use) with typed entries."""
    global _loaded
    if _loaded is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded = lib
    return _loaded


def check(rc: int, name: str) -> None:
    """Raise when a C entry reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} (cudaError_t)")
