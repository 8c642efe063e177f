"""K7 and K8: the port's toolchain probes (``csrc/probe.cu``).

Counterparts of ``tools/probe_pallas.py``, which checked that a Pallas
kernel compiles and runs on the TPU: ``affine`` is its ``f`` (x * 2 + 1)
and ``stencil`` its ``g`` (a periodic 3-point lane stencil,
x + roll(x, 1, 1) + roll(x, -1, 1)), on a [256, 256] float32 array.  A
CUDA tensor always runs the hand-written kernel (``affine_cuda``,
``stencil_cuda``, each counting its launches); a CPU tensor runs the
plain torch version.  The kernels agree with the plain versions bit for
bit.  Run on the GPU machine from the repository root:

    python -m fv3net_tpu_torch.probe

which builds the kernels, runs both probes, checks them against the plain
versions and prints the times.
"""

from __future__ import annotations

import time

import torch

from .ops import _build

SHAPE = (256, 256)


def affine_plain(x):
    """x * 2 + 1 (tools/probe_pallas.py ``kern``)."""
    return x * 2.0 + 1.0


def stencil_plain(x):
    """x + roll(x, 1, 1) + roll(x, -1, 1) (tools/probe_pallas.py
    ``stenc``)."""
    return x + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)


def _out(x, name):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors")
    if x.dim() != 2:
        raise ValueError(f"{name}: expected a 2-D array, got {x.dim()}-D")
    _build.check(x, "x", x.shape, dev)
    return torch.empty_like(x)


def affine_cuda(x):
    """K7 on a [rows, cols] float32 CUDA tensor."""
    y = _out(x, "affine_cuda")
    _build.call("fv3_probe_affine", x.data_ptr(), y.data_ptr(), x.numel(),
                _build.stream())
    affine_cuda.launches += 1
    return y


def stencil_cuda(x):
    """K8 on a [rows, cols] float32 CUDA tensor."""
    y = _out(x, "stencil_cuda")
    _build.call("fv3_probe_stencil", x.data_ptr(), y.data_ptr(),
                x.shape[0], x.shape[1], _build.stream())
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
