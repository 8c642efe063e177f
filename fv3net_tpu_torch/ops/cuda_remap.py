"""K5 wrapper: the conservative PPM vertical remap kernel (``csrc/remap.cu``).

Replaces the TPU kernel
``fv3net_tpu/ops/pallas_remap.py::ppm_remap_pallas``.  The plain version
is ``ops/remap.py::remap_levels_plain`` (``ppm_remap`` with
exact_boundaries=True on the native layout); ``remap.remap_levels``
dispatches here for CUDA tensors whose (iv, kord) the kernel covers.
"""

from __future__ import annotations

import torch

from . import _build
from .remap import kernel_covers


@_build.counted("ppm_remap")
def ppm_remap_cuda(q1, pe1, pe2, iv: int, kord: int):
    """q2 [F, kn, Y, X] of ``remap_levels_plain`` from the CUDA kernel.

    q1: [F, km, Y, X]; pe1: [Fp, km+1, Y, X]; pe2: [Fp, kn+1, Y, X], F a
    multiple of Fp (field f uses pressure face f % Fp); float32 on one
    CUDA device.
    """
    if not kernel_covers(iv, kord):
        raise ValueError(f"K5 does not cover iv={iv} kord={kord}")
    dev = q1.device
    if dev.type != "cuda":
        raise ValueError("ppm_remap_cuda takes CUDA tensors")
    F, km, Y, X = q1.shape
    Fp = pe1.shape[0]
    kn = pe2.shape[1] - 1
    if km < 4 or Fp == 0 or F % Fp:
        raise ValueError(
            f"need km >= 4 and a pressure face count dividing {F}, got "
            f"km={km}, {Fp} faces"
        )
    ptrs = [
        _build.check(q1, "q1", (F, km, Y, X), dev),
        _build.check(pe1, "pe1", (Fp, km + 1, Y, X), dev),
        _build.check(pe2, "pe2", (Fp, kn + 1, Y, X), dev),
    ]
    q2 = torch.empty((F, kn, Y, X), dtype=torch.float32, device=dev)
    qe = torch.empty((F, km + 1, Y, X), dtype=torch.float32, device=dev)
    gam = torch.empty((F, km, Y, X), dtype=torch.float32, device=dev)
    _build.call(
        "fv3_remap", *ptrs, q2.data_ptr(), qe.data_ptr(), gam.data_ptr(),
        F, Fp, km, kn, Y * X, iv, kord, _build.stream(),
    )
    _build.launched(ppm_remap_cuda)
    return q2
