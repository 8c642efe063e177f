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


@_build.counted("sim1_solver")
def sim1_solver_cuda(dt, dm, pt, dz, w, pem, pm, ws, p_fac: float = 0.05,
                     halo: int = 0):
    """(w2, dz2, ppe) of ``sim1_solver`` from the CUDA kernel.

    dm, pt, dz, w: [F, nz, n, n]; pem [F, nz+1, N, N], pm [F, nz, N, N]
    and ws [F, N, N] with N = n + 2 halo, of which the kernel reads the
    n x n interior (the halo-padded fields of the step, without a copy);
    float32, contiguous, on one CUDA device.  Returns w2, dz2 [F, nz, n,
    n] and ppe [F, nz+1, n, n].
    """
    if halo < 0:
        raise ValueError(f"halo must be >= 0, got {halo}")
    dev = dm.device
    if dev.type != "cuda":
        raise ValueError("sim1_solver_cuda takes CUDA tensors")
    F, nz, ny, nx = dm.shape
    if ny != nx:
        raise ValueError(f"sim1_solver_cuda takes square faces: {ny}x{nx}")
    N = nx + 2 * halo
    lay, ifc = (F, nz, ny, nx), (F, nz + 1, ny, nx)
    ptrs = [
        _build.check(t, name, shape, dev)
        for t, name, shape in (
            (dm, "dm", lay), (pt, "pt", lay), (dz, "dz", lay),
            (w, "w", lay), (pem, "pem", (F, nz + 1, N, N)),
            (pm, "pm", (F, nz, N, N)), (ws, "ws", (F, N, N)),
        )
    ]
    w2 = torch.empty(lay, dtype=torch.float32, device=dev)
    dz2 = torch.empty_like(w2)
    ppe = torch.empty(ifc, dtype=torch.float32, device=dev)
    _build.call(
        "fv3_sim1", *ptrs, w2.data_ptr(), dz2.data_ptr(), ppe.data_ptr(),
        F, nz, nx, halo, float(dt), float(p_fac), RDGAS,
        REFERENCE_SURFACE_PRESSURE, GAMMA, -CV_AIR / CP_AIR, _build.stream(),
    )
    _build.launched(sim1_solver_cuda)
    return w2, dz2, ppe
