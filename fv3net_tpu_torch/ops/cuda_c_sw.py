"""The C-grid half-stage (FV3's c_sw) as three fused kernels
(``csrc/c_sw.cu``).

``dycore/hydro.py::_c_sw_half_3d`` runs ``c_sw_half_cuda`` where
``hydro._c_sw_fused`` says so: CUDA tensors, the single-process exchanges
(no ``grid.halo.spmd_mode``) and metrics of whole faces (``m.edge_w``
None).  Everything else (the CPU, the meshes' shards, within-face tiles)
takes ``hydro._c_sw_half_chain``, the kernels' plain version.  The
kernels read the C-grid canonicalisation and exchanges through their
composed tables (``grid/halo.py::cgrid_canon_gather_flat``) and the
surface geopotential through its x-fill table (``scalar_gather_flat``);
the column chain of K4 (csrc/column.cu) is folded into the second
kernel.  One call, one count
(``COUNTED["c_sw_half"]``): three launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..constants import CP_AIR, KAPPA, REFERENCE_SURFACE_PRESSURE as P00
from ..grid import halo as halo_mod
from . import _build

# metrics the kernels read, in the C entry point's order, with their
# shapes as functions of (n, N)
METRICS = (
    ("cosa_u", "pad"), ("rsin2_u", "pad"), ("cosa_v", "pad"),
    ("rsin2_v", "pad"), ("xbw_w", "edge"), ("xbw_e", "edge"),
    ("ybw_s", "edge"), ("ybw_n", "edge"), ("dy_fs", "pad"),
    ("dx_fs", "pad"), ("area_px", "pad"), ("dx_u", "u"), ("dy_v", "v"),
    ("f_px", "pad"), ("dxc_f", "pad"), ("dyc_f", "pad"),
)


@_build.counted("c_sw_half")
def c_sw_half_cuda(m, dt2: float, ptop: float, phis, up, vp, dpx, dpy,
                   ptx, pty):
    """(uc, vc): the advective C winds of ``_c_sw_half_3d`` from the
    kernels, padded [6, nz, N, N] each (uc fill x, vc fill y).

    up [6, nz, N+1, N], vp [6, nz, N, N+1]: the D-grid exchange; dpx, dpy,
    ptx, pty [6, nz, N, N]: the x- and y-fill exchanges of delp and pt;
    phis [6, n, n] or None; m: face-level SWMetrics.  float32 on one CUDA
    device."""
    dev = dpx.device
    if dev.type != "cuda":
        raise ValueError("c_sw_half_cuda takes CUDA tensors")
    n, h = m.n, m.halo
    if h < 2:
        raise ValueError(f"c_sw_half_cuda needs halo >= 2, got {h}")
    F, nz, N, _ = dpx.shape
    if F != 6 or N != n + 2 * h:
        raise ValueError(f"dpx: expected [6, nz, {n + 2 * h}, "
                         f"{n + 2 * h}], got {tuple(dpx.shape)}")
    field = (6, nz, N, N)
    if 6 * nz * (N + 1) * N >= 2 ** 31:
        raise ValueError(f"{field} does not fit int32 indices")
    shapes = {"pad": (6, N, N), "edge": (6, n, 4), "u": (6, N + 1, N),
              "v": (6, N, N + 1)}
    ptrs = [
        _build.check(up, "up", (6, nz, N + 1, N), dev),
        _build.check(vp, "vp", (6, nz, N, N + 1), dev),
        *(_build.check(t, name, field, dev) for t, name in
          ((dpx, "dpx"), (dpy, "dpy"), (ptx, "ptx"), (pty, "pty"))),
        *(_build.check(getattr(m, name), name, shapes[kind], dev)
          for name, kind in METRICS),
    ]
    src, coef = halo_mod.cgrid_canon_gather_flat(n, h, dev)
    ptrs += [src.data_ptr(), coef.data_ptr()]
    if phis is None:
        ptrs += [None, None]
    else:
        ptrs += [halo_mod.scalar_gather_flat(n, h, 1, "x", dev).data_ptr(),
                 _build.check(phis, "phis", (6, n, n), dev)]
    # the first stage's four lattices and the columns' three fields are
    # the call's scratch; the last two its result
    out = [torch.empty(field, dtype=torch.float32, device=dev)
           for _ in range(9)]

    def array(ps):
        return (ctypes.c_void_p * len(ps))(*ps)

    _build.call(
        "fv3_c_sw_half", array(ptrs), array([t.data_ptr() for t in out]),
        nz, n, h, float(dt2), float(ptop), P00, KAPPA, CP_AIR,
        _build.stream(),
    )
    _build.launched(c_sw_half_cuda)
    return out[7], out[8]
