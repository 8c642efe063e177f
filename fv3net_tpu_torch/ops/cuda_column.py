"""K4: the columnar pressure / Exner chain (``csrc/column.cu``).

Replaces the TPU kernel
``fv3net_tpu/ops/pallas_column.py::column_pressures_pallas``.  From layer
thicknesses dp [F, nz, Y, X] it forms the interface pressures pe (prefix
sum from ptop), the hydrostatically consistent layer-mean Exner function
pi_lay and the log-mean layer pressure pm = dp/dlnp (FV3's pm2).
``column_pressures`` runs the kernel for CUDA tensors and
``column_pressures_plain`` (the JAX package's jnp chain at
``dycore/hydro.py:528-539`` plus ``layer_mean_pressure``) for CPU tensors.
"""

from __future__ import annotations

import torch

from ..constants import KAPPA, REFERENCE_SURFACE_PRESSURE as P00
from ..dycore.riemann import layer_mean_pressure
from . import _build


def column_pressures(dp, ptop: float):
    """(pe, pi_lay, pm) from dp: the kernel on CUDA, else plain."""
    if dp.is_cuda:
        return column_pressures_cuda(dp.contiguous(), ptop)
    return column_pressures_plain(dp, ptop)


def column_pressures_plain(dp, ptop: float):
    """The plain torch chain (any device)."""
    pe, _, pi_lay = exner_chain(dp, ptop)
    return pe, pi_lay, layer_mean_pressure(dp, pe)


def exner_chain(dp, ptop: float):
    """(pe, pik, pi_lay): interface pressures, the interface Exner
    function and the hydrostatically consistent layer-mean Exner function
    pi = (pik+ pe+ - pik- pe-) / ((1 + kappa) dp), in plain torch (the
    hydrostatic dycore's chain, which needs pik)."""
    pe = ptop + torch.cat(
        [torch.zeros_like(dp[:, :1]), torch.cumsum(dp, dim=1)], dim=1
    )
    pik = (pe / P00) ** KAPPA  # Exner at interfaces
    pi_lay = (
        pik[:, 1:] * pe[:, 1:] - pik[:, :-1] * pe[:, :-1]
    ) / ((1.0 + KAPPA) * dp)
    return pe, pik, pi_lay


def column_pressures_cuda(dp, ptop: float):
    """(pe, pi_lay, pm) from the CUDA kernel; dp [F, nz, Y, X] float32."""
    dev = dp.device
    if dev.type != "cuda":
        raise ValueError("column_pressures_cuda takes CUDA tensors")
    F, nz, Y, X = dp.shape
    ptr = _build.check(dp, "dp", (F, nz, Y, X), dev)
    pe = torch.empty((F, nz + 1, Y, X), dtype=torch.float32, device=dev)
    pi_lay = torch.empty_like(dp)
    pm = torch.empty_like(dp)
    _build.call(
        "fv3_column", ptr, pe.data_ptr(), pi_lay.data_ptr(), pm.data_ptr(),
        F, nz, Y * X, float(ptop), P00, KAPPA, _build.stream(),
    )
    column_pressures_cuda.launches += 1
    return pe, pi_lay, pm


column_pressures_cuda.launches = 0
