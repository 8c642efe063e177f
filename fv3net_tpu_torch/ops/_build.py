"""Build, load and call the package's CUDA kernels (``csrc/*.cu``).

At first use every ``.cu`` file is compiled by ``nvcc`` for ``sm_90a``,
one ``nvcc`` process per source, all started together, and the objects
are linked into ONE shared library with a plain C interface, which is
loaded with ``ctypes``.  The library lives under ``build/kernels/`` at
the repository root, named by a hash of the sources, the headers they
share (``csrc/*.cuh``) and the flags, so an edited source is rebuilt and
an unchanged one is reused.  Nothing here runs at import time: the CPU
tests import every module on machines without ``nvcc`` or a GPU.  There
is no fallback: a CUDA tensor that reaches a kernel whose library cannot
be built raises.
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
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)  # a host array of device pointers

# argtypes of every C entry point in csrc/ (each returns an int error code)
SIGNATURES = {
    "fv3_tp2d": [_P] * 8 + [_I] * 2 + [_P] * 2 + [_I] * 5 + [_P],
    "fv3_sim1": [_P] * 10 + [_I] * 4 + [_F] * 6 + [_P],
    "fv3_column": [_P] * 4 + [_I] * 3 + [_F] * 3 + [_P],
    "fv3_del4": [_P] * 6 + [_I] * 5 + [_F] + [_P],
    "fv3_del4_pair": [_P] * 5 + [_I] * 5 + [_F] + [_P],
    "fv3_remap": [_P] * 6 + [_I] * 7 + [_P],
    "fv3_tp2d_multi5": [_PP] * 2 + [_I] * 4 + [_P],
    "fv3_probe_affine": [_P] * 2 + [_L] * 3 + [_I] + [_P],
    "fv3_probe_stencil": [_P] * 2 + [_L] + [_I] * 4 + [_P],
    "fv3_probe_resident": [_I],
}

_lib = None
_entry = {}  # name -> the library's C entry point, bound once
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
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(sources, objs)
    ]
    logs = [proc.communicate()[0] for proc in procs]
    try:
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} ({proc.returncode}):\n"
                    f"{log[-8000:]}"
                )
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
             *map(str, objs)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to link ({link.returncode}):\n"
                f"{link.stderr[-8000:]}"
            )
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    build_info.update(
        path=str(out), seconds=time.perf_counter() - t0,
        log="".join(logs) + link.stdout + link.stderr,
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
    fn = _entry.get(name)
    if fn is None:
        fn = _entry[name] = getattr(library(), name)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error code {err}")


def stream() -> int:
    """Handle of the current CUDA stream of the current device, for the
    kernels' launches: torch's raw lookup, since
    ``torch.cuda.current_stream().cuda_stream`` builds a Stream object
    first (5-8 us of a wrapper's host time on the H100 machine,
    kernel_times.py)."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def check(t: torch.Tensor, name: str, shape: tuple, device) -> int:
    """Validate a kernel operand; returns its data pointer."""
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(
            f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.data_ptr()


# A block of K1 or K3 loops over a run of up to MAX_LEVELS levels of its
# tile, fewer where the card would otherwise get fewer than ~BLOCKS blocks
# (runs of 8 levels at C192 and 1 at C48 were the fastest of 1-8 for K1
# and of 1-16 for K3 on the H100, kernel_variants.py).
MAX_LEVELS, BLOCKS = 8, 2048


def levels_per_block(tiles: int, slabs: int) -> int:
    """Levels each block loops over for `tiles` tiles of each of `slabs`
    (face, level) slabs."""
    return max(1, min(MAX_LEVELS, tiles * slabs // BLOCKS))
