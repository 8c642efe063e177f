"""K3 wrapper: the del-4 filter kernel (``csrc/filter.cu``).

Replaces the TPU kernel
``fv3net_tpu/ops/pallas_filter.py::del4_filter_pallas``.  The plain
version is the L_local form of ``dycore/sw.py::scalar_filter``, which
dispatches here for CUDA tensors.
"""

from __future__ import annotations

import torch

from . import _build


def del4_filter_cuda(qx, qy, area_px, area_py, c: float, halo: int):
    """q - (c/8) L(L(q)) on the padded lattice, cropped to the interior.

    qx/qy: the field with x-fill / y-fill halo exchanges applied
    [F, nz, N, N]; area_px/area_py the matching padded cell areas
    [F, N, N]; float32 on one CUDA device.  Returns [F, nz, n, n].
    """
    dev = qx.device
    if dev.type != "cuda":
        raise ValueError("del4_filter_cuda takes CUDA tensors")
    F, nz, N, _ = qx.shape
    n = N - 2 * halo
    ptrs = [
        _build.check(t, name, shape, dev)
        for t, name, shape in (
            (qx, "qx", (F, nz, N, N)), (qy, "qy", (F, nz, N, N)),
            (area_px, "area_px", (F, N, N)),
            (area_py, "area_py", (F, N, N)),
        )
    ]
    l1 = torch.empty((F, nz, N, N), dtype=torch.float32, device=dev)
    out = torch.empty((F, nz, n, n), dtype=torch.float32, device=dev)
    _build.call(
        "fv3_del4", *ptrs, l1.data_ptr(), out.data_ptr(), F, nz, N, halo,
        float(c) / 8.0, _build.stream(),
    )
    del4_filter_cuda.launches += 1
    return out


del4_filter_cuda.launches = 0
