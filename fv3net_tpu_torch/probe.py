"""K7 and K8: the port's toolchain probes (``csrc/probe.cu``).

Counterparts of ``tools/probe_pallas.py``, which checked that a Pallas
kernel compiles and runs on the TPU: ``affine`` is its ``f`` (x * 2 + 1)
and ``stencil`` its ``g`` (a periodic 3-point lane stencil,
x + roll(x, 1, 1) + roll(x, -1, 1)), on a [256, 256] float32 array.  A
CUDA tensor always runs the hand-written kernel (``affine_cuda``,
``stencil_cuda``, each counting its launches); a CPU tensor runs the
plain torch version.  The kernels agree with the plain versions bit for
bit, on any contiguous float32 [rows, cols] tensor with cols < 2^31
(``stencil``).  ``affine_plan`` and ``stencil_plan`` give each launch's
plan, which the CPU tests walk thread by thread.  Run on the GPU machine
from the repository root:

    python -m fv3net_tpu_torch.probe

which builds the kernels, runs both probes, checks them against the plain
versions and prints the times.
"""

from __future__ import annotations

import functools
import time

import torch

from .ops import _build

SHAPE = (256, 256)
THREADS = 256  # kThreads in csrc/probe.cu
UNROLL = 4  # kUnroll: float4 (K7) or 32-chunk segments (K8) a thread
WARPS = THREADS // 32
COLS_LIMIT = 2 ** 31  # K8 indexes a row's columns in 32 bits
# A grid covers the whole work up to WAVES x the blocks the card holds at
# once; beyond that the kernels' grid-stride loops take the rest.  On the
# H100 a [16384, 16384] array streamed faster the more blocks its grid
# had, from one wave of resident blocks to one block a tile
# (``kernel_variants.py --only probe``; PERF.md); 128 waves cover the
# whole work of arrays up to 2.2 GB (K7) and 1.1 GB (K8).
WAVES = 128


def affine_plain(x):
    """x * 2 + 1 (tools/probe_pallas.py ``kern``)."""
    return x * 2.0 + 1.0


def stencil_plain(x):
    """x + roll(x, 1, 1) + roll(x, -1, 1) (tools/probe_pallas.py
    ``stenc``)."""
    return x + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)


# The plans depend on the addresses only through their offsets from a
# 16-byte boundary, so a wrapper's repeated calls at one shape reuse one
# plan and skip its arithmetic on the host path.
@functools.lru_cache(maxsize=64)
def affine_plan(n, ax, ay, max_blocks):
    """(head, nvec, blocks) of K7 on n floats whose x and y start ax and
    ay bytes past a 16-byte boundary: float4 over [head, head + 4 nvec)
    where the two offsets agree, the rest scalar; a block a tile of
    UNROLL x THREADS vectors (or THREADS scalars), at most `max_blocks`."""
    head = nvec = 0
    if not ((ax | ay) & 3 or ax != ay):
        head = min(n, (-ax & 15) >> 2)
        nvec = (n - head) >> 2
    tiles = max(-(-nvec // (UNROLL * THREADS)),
                -(-(n - 4 * nvec) // THREADS))
    return head, nvec, max(1, min(max_blocks, tiles))


@functools.lru_cache(maxsize=64)
def stencil_plan(rows, cols, ax, ay, max_blocks):
    """(vec, warps_per_row, blocks) of K8 on [rows, cols] whose x and y
    start ax and ay bytes past a 16-byte boundary: float4 chunks where
    every row starts on one in x and y, else single columns; a warp a
    group of UNROLL x 32 chunks of a row, at most `max_blocks` blocks
    (float4, single)."""
    if cols >= COLS_LIMIT:
        raise ValueError(f"stencil: cols must be below 2^31, got {cols}")
    vec = 1 if cols & 3 or ax | ay else 4
    groups = -(-cols // (UNROLL * 32 * vec))
    blocks = max(1, min(max_blocks[vec == 1], -(-rows * groups // WARPS)))
    return vec, min(groups, blocks * WARPS), blocks


_entry = None  # (affine, stencil, max blocks: K7, (K8 float4, single))


def _bind():
    """The library's probe entry points and their grids' caps (WAVES x
    the card's resident blocks), bound and queried once."""
    global _entry
    lib = _build.library()
    resident = [lib.fv3_probe_resident(k) for k in range(3)]
    if min(resident) <= 0:
        raise RuntimeError(
            f"fv3_probe_resident failed with CUDA error code "
            f"{-min(resident)}")
    cap = [WAVES * r for r in resident]
    _entry = (lib.fv3_probe_affine, lib.fv3_probe_stencil, cap[0],
              (cap[1], cap[2]))
    return _entry


def _refuse(x, name):
    if not isinstance(x, torch.Tensor) or not x.is_cuda:
        raise ValueError(f"{name} takes CUDA tensors")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{name}: expected a 2-D array, got {x.dim()}-D")
    raise ValueError(f"{name}: expected a contiguous tensor")


def _like_offset(x, px):
    """An empty tensor like x whose data starts at px's offset from a
    16-byte boundary (a view into a buffer 3 floats longer)."""
    n = x.numel()
    buf = torch.empty(n + 3, dtype=x.dtype, device=x.device)
    o = ((px - buf.data_ptr()) & 15) >> 2
    return buf[o:o + n].view(x.shape)


def affine_cuda(x):
    """K7 on a contiguous [rows, cols] float32 CUDA tensor."""
    if not (isinstance(x, torch.Tensor) and x.is_cuda
            and x.dtype == torch.float32 and x.dim() == 2
            and x.is_contiguous()):
        _refuse(x, "affine_cuda")
    affine, _, max_blocks, _ = _entry or _bind()
    y = torch.empty_like(x)
    n, px, py = x.numel(), x.data_ptr(), y.data_ptr()
    if (px ^ py) & 15:
        y = _like_offset(x, px)
        py = y.data_ptr()
    if n:
        err = affine(px, py, n, *affine_plan(n, px & 15, py & 15, max_blocks),
                     _build.stream())
        if err:
            raise RuntimeError(f"fv3_probe_affine failed with CUDA error "
                               f"code {err}")
        affine_cuda.launches += 1
    return y


def stencil_cuda(x):
    """K8 on a contiguous [rows, cols] float32 CUDA tensor."""
    if not (isinstance(x, torch.Tensor) and x.is_cuda
            and x.dtype == torch.float32 and x.dim() == 2
            and x.is_contiguous()):
        _refuse(x, "stencil_cuda")
    _, stencil, _, max_blocks = _entry or _bind()
    y = torch.empty_like(x)
    rows, cols = x.shape
    if rows and cols:
        px, py = x.data_ptr(), y.data_ptr()
        err = stencil(px, py, rows, cols, *stencil_plan(
            rows, cols, px & 15, py & 15, max_blocks), _build.stream())
        if err:
            raise RuntimeError(f"fv3_probe_stencil failed with CUDA error "
                               f"code {err}")
        stencil_cuda.launches += 1
    return y


affine_cuda.launches = 0
stencil_cuda.launches = 0


def affine(x):
    """K7 for CUDA tensors, the plain version for CPU tensors."""
    return affine_cuda(x.contiguous()) if x.is_cuda else affine_plain(x)


def stencil(x):
    """K8 for CUDA tensors, the plain version for CPU tensors."""
    return stencil_cuda(x.contiguous()) if x.is_cuda else stencil_plain(x)


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA device")
    t0 = time.perf_counter()
    _build.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    x = torch.randn(SHAPE, generator=torch.Generator().manual_seed(0))
    x = x.cuda()
    for name, fn, plain in (("affine", affine, affine_plain),
                            ("stencil", stencil, stencil_plain)):
        t0 = time.perf_counter()
        y = fn(x)
        torch.cuda.synchronize()
        same = torch.equal(y, plain(x))
        print(f"{name}: first call {1e3 * (time.perf_counter() - t0):.3f} "
              f"ms, equal to plain: {same}", flush=True)
        if not same:
            raise AssertionError(f"{name} differs from its plain version")


if __name__ == "__main__":
    main()
