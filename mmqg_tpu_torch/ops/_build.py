"""Build the package's CUDA kernels into one shared library and load it.

The sources under ``mmqg_tpu_torch/csrc/`` have a plain C interface, so they
compile with ``nvcc`` alone (seconds) into ``libmmqg_kernels.so`` and load
with ``ctypes`` -- no PyTorch headers, no extension build. Each ``.cu`` file
compiles in its own ``nvcc`` process, all started together, and one more
links the objects. The library goes
under ``mmqg_tpu_torch/build/<hash of the sources and flags>/`` at first
use, so an edited source rebuilds and an unchanged one is reused. There is
no fallback: without ``nvcc`` the build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points and their argument types: every pointer and the stream are
# c_void_p (a bare Python int would be cut to 32 bits), every int is c_int.
SIGNATURES = {
    "mmqg_lstm_seq": [_P] * 12 + [_I] * 6 + [_P],
    "mmqg_lstm_seq_rows": [_I] * 3,
    "mmqg_lstm_input_proj": [_P] * 4 + [_I] * 4 + [_P],
    "mmqg_lstm_barrier_floor": [_P] + [_I] * 3 + [_P],
    "mmqg_trimodal_attention": [_P] * 13 + [_I] * 8 + [_P],
    "mmqg_trimodal_attention_workspace": [_I] * 7 + [_P],
    "mmqg_trimodal_attention_tiled": [_P] * 16 + [_I] * 8 + [_P],
    "mmqg_lstm_train_fwd": [_P] * 11 + [_I] * 6 + [_P],
    "mmqg_lstm_train_fwd_rows": [_I] * 3,
    "mmqg_lstm_train_bwd": [_P] * 19 + [_I] * 6 + [_P],
    "mmqg_lstm_train_bwd_persistent": [_I] * 3,
    "mmqg_vggish_conv": [_P] * 4 + [_I] * 7 + [_P],
    "mmqg_vggish_conv_int8": [_P] * 6 + [_I] * 7 + [_P],
    "mmqg_vggish_conv_s8": [_P] * 8 + [_I] * 7 + [_P],
    "mmqg_quantize_s8": [_P] * 4 + [_I] * 4 + [_P],
}


class Build(NamedTuple):
    path: Path        # the shared library
    seconds: float    # time nvcc took (0.0 when a built library was reused)
    log: str          # nvcc's output, ptxas register and spill report included


_loaded: Optional[ctypes.CDLL] = None
_build: Optional[Build] = None
# the wrappers' launch and route counts are bumped under this lock: a
# sharded pipeline's dispatch thread (parallel.replicas) launches while the
# caller's thread, or another pipeline's dispatch thread, may launch too
COUNT_LOCK = threading.Lock()


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
    work = Path(tempfile.mkdtemp(dir=out_dir))
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        objs.append(str(work / f"{src.stem}.o"))
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [(p.communicate()[0], p.returncode) for p in procs]
    log = "".join(out for out, _ in outs)
    rc = next((code for _, code in outs if code != 0), 0)
    if rc == 0:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o",
                               str(work / lib.name), *objs],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        rc = link.returncode
    seconds = time.perf_counter() - t0
    if rc != 0:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"nvcc failed ({rc}):\n{log}")
    # atomic: a concurrent build never sees half a file
    os.replace(work / lib.name, lib)
    shutil.rmtree(work, ignore_errors=True)
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


ROUTES = ("persistent", "per_step")


def sweep_rows(entry: str, B: int, H: int, bf16: bool, device: int,
               force_route: Optional[str] = None) -> int:
    """How an LSTM recurrence runs at (B, H) on CUDA device ``device``
    (made current by the caller), decided before any launch: 0 for one
    launch a step ("per_step"), else the 16-row blocks of the batch each
    cooperative launch of its sweep takes ("persistent"). By shape, as the
    C entry ``entry`` says (the backward's says 1: all of them, or 0);
    ``force_route`` "per_step" gives 0, "persistent" the whole batch in
    one launch, which the device refuses where it cannot all be
    resident."""
    if force_route == "per_step":
        return 0
    if force_route == "persistent":
        return -(-B // 16)
    return _entry_rows(entry, B, H, bf16, device)


@functools.lru_cache(maxsize=None)
def _entry_rows(entry: str, B: int, H: int, bf16: bool, device: int) -> int:
    n = getattr(library(), entry)(B, H, int(bf16))
    if n < 0:
        raise RuntimeError(f"{entry}: CUDA error {-n} (cudaError_t)")
    return n


def route_of(rows: int) -> str:
    """The route name of a :func:`sweep_rows` answer."""
    return ROUTES[0] if rows else ROUTES[1]


def check(rc: int, name: str) -> None:
    """Raise when a C entry reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} (cudaError_t)")
