"""Build, load and call the package's CUDA kernels (``csrc/*.cu``).

At first use every ``.cu`` file is compiled by ``nvcc`` for ``sm_90a``
into ONE shared library with a plain C interface, which is loaded with
``ctypes``.  The library lives under ``build/kernels/`` at the repository
root, named by a hash of the sources, the headers they share
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing here runs at import
time: the CPU tests import every module on machines without ``nvcc`` or a
GPU.  There is no fallback: a CUDA tensor that reaches a kernel whose
library cannot be built raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)  # a host array of device pointers

# argtypes of every C entry point in csrc/ (each returns an int error code)
SIGNATURES = {
    "fv3_tp2d": [_P] * 8 + [_L, _L] + [_P] * 4 + [_I] * 4 + [_P],
    "fv3_sim1": [_P] * 12 + [_I] * 3 + [_F] * 6 + [_P],
    "fv3_column": [_P] * 4 + [_I] * 3 + [_F] * 3 + [_P],
    "fv3_del4": [_P] * 6 + [_I] * 4 + [_F] + [_P],
    "fv3_remap": [_P] * 6 + [_I] * 7 + [_P],
    "fv3_tp2d_multi5": [_PP] * 3 + [_I] * 4 + [_P],
    "fv3_probe_affine": [_P] * 2 + [_L] + [_P],
    "fv3_probe_stencil": [_P] * 2 + [_I] * 2 + [_P],
}

_lib = None
build_info = {}  # path, seconds and compiler output of the last build


def find_nvcc() -> str:
    """Path of nvcc (PATH first, then the toolkit's default prefix)."""
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: fv3net_tpu_torch builds its CUDA kernels "
            "(csrc/*.cu) with nvcc at first use; put the CUDA toolkit's "
            "bin/ on PATH"
        )
    return path


def build() -> Path:
    """Compile csrc/*.cu into one shared library unless an identical
    build exists; returns its path."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libfv3kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, log="(cached)")
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}"
        )
    os.replace(tmp, out)
    build_info.update(
        path=str(out), seconds=time.perf_counter() - t0,
        log=proc.stdout + proc.stderr,
    )
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def call(name: str, *args) -> None:
    """Call a C entry point; raise if it reports a CUDA error."""
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error code {err}")


def stream() -> int:
    """Handle of the current CUDA stream, for the kernels' launches."""
    return torch.cuda.current_stream().cuda_stream


def check(t: torch.Tensor, name: str, shape, device) -> int:
    """Validate a kernel operand; returns its data pointer."""
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.data_ptr()
