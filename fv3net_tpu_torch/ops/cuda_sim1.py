"""K2 wrapper: the semi-implicit vertical solver kernel (``csrc/sim1.cu``).

Replaces the TPU kernel
``fv3net_tpu/ops/pallas_sim1.py::sim1_solver_pallas``.  The plain version
is ``dycore/riemann.py::sim1_solver``; ``riemann.sim1_solve`` dispatches
here for CUDA tensors.
"""

from __future__ import annotations

import torch

from ..constants import CP_AIR, CV_AIR, RDGAS, REFERENCE_SURFACE_PRESSURE
from . import _build

GAMMA = CP_AIR / CV_AIR


def sim1_solver_cuda(dt, dm, pt, dz, w, pem, pm, ws, p_fac: float = 0.05):
    """(w2, dz2, ppe) of ``sim1_solver`` from the CUDA kernel.

    dm, pt, dz, w, pm: [F, nz, n, n]; pem: [F, nz+1, n, n]; ws: [F, n, n];
    float32 on one CUDA device.
    """
    dev = dm.device
    if dev.type != "cuda":
        raise ValueError("sim1_solver_cuda takes CUDA tensors")
    F, nz, ny, nx = dm.shape
    lay, ifc = (F, nz, ny, nx), (F, nz + 1, ny, nx)
    ptrs = [
        _build.check(t, name, shape, dev)
        for t, name, shape in (
            (dm, "dm", lay), (pt, "pt", lay), (dz, "dz", lay),
            (w, "w", lay), (pem, "pem", ifc), (pm, "pm", lay),
            (ws, "ws", (F, ny, nx)),
        )
    ]
    w2 = torch.empty(lay, dtype=torch.float32, device=dev)
    dz2 = torch.empty_like(w2)
    ppe = torch.empty(ifc, dtype=torch.float32, device=dev)
    pp = torch.empty_like(ppe)  # scratch: interface perturbation sweep
    gam = torch.empty_like(w2)  # scratch: Thomas factors
    _build.call(
        "fv3_sim1", *ptrs, w2.data_ptr(), dz2.data_ptr(), ppe.data_ptr(),
        pp.data_ptr(), gam.data_ptr(), F, nz, ny * nx, float(dt),
        float(p_fac), RDGAS, REFERENCE_SURFACE_PRESSURE, GAMMA,
        -CV_AIR / CP_AIR, _build.stream(),
    )
    sim1_solver_cuda.launches += 1
    return w2, dz2, ppe


sim1_solver_cuda.launches = 0
