"""K3 wrapper: the del-4 filter kernel (``csrc/filter.cu``).

Replaces the TPU kernel
``fv3net_tpu/ops/pallas_filter.py::del4_filter_pallas``.  The plain
version is the L_local form of ``dycore/sw.py::scalar_filter``, which
dispatches here for CUDA tensors.  The TPU kernel takes the x-fill and
y-fill exchanges of q; this one takes q itself and reads both exchanges
through their gather tables (``grid/halo.py::scalar_gather_flat``), so no
exchanged copy is written.
"""

from __future__ import annotations

import torch

from ..grid import halo as halo_mod
from . import _build

TX, TY = 48, 16  # csrc/filter.cu's tile


def del4_filter_cuda(q, area_px, area_py, c: float, halo: int):
    """q - (c/8) L(L(q)) on the interior, from q itself.

    q: [6, nz, n, n]; area_px/area_py the padded cell areas with x-fill /
    y-fill corners [6, N, N]; float32 on one CUDA device.  Returns
    [6, nz, n, n], what ``scalar_filter`` gives after its two exchanges.
    """
    if halo < 2:
        raise ValueError(f"del4_filter_cuda needs halo >= 2, got {halo}")
    F, nz, n, _ = q.shape
    if F != 6:
        raise ValueError(f"q: expected 6 cube faces, got shape {q.shape}")
    if q.numel() >= 2 ** 31:
        raise ValueError(f"q {tuple(q.shape)} does not fit int32 indices")
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("del4_filter_cuda takes CUDA tensors")
    N = n + 2 * halo
    ptrs = [
        _build.check(q, "q", (F, nz, n, n), dev),
        halo_mod.scalar_gather_flat(n, halo, nz, "x", dev).data_ptr(),
        halo_mod.scalar_gather_flat(n, halo, nz, "y", dev).data_ptr(),
        _build.check(area_px, "area_px", (F, N, N), dev),
        _build.check(area_py, "area_py", (F, N, N), dev),
    ]
    out = torch.empty((F, nz, n, n), dtype=torch.float32, device=dev)
    lv = _build.levels_per_block(-(-n // TX) * -(-n // TY), F * nz)
    _build.call(
        "fv3_del4", *ptrs, out.data_ptr(), F, nz, n, halo, lv,
        float(c) / 8.0, _build.stream(),
    )
    del4_filter_cuda.launches += 1
    return out


del4_filter_cuda.launches = 0
