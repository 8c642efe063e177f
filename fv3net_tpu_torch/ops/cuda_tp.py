"""K1 and K6 wrappers: the Lin-Rood 2D transport kernels.

K1 (``csrc/tp2d.cu``) replaces the TPU kernel
``fv3net_tpu/ops/pallas_tp.py::fv_tp_2d_pallas``; its plain version is
``ops/advection.py::fv_tp_2d_plain`` and ``advection.fv_tp_2d``
dispatches here for CUDA tensors.  K6 (``csrc/tp2d_multi5.cu``) replaces
``fv3net_tpu/ops/pallas_tp.py::fv_tp_2d_multi5``, the D stage's five
transports fused; its plain version is
``ops/advection.py::fv_tp_2d_multi5_plain`` and
``advection.fv_tp_2d_multi5`` dispatches here for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def fv_tp_2d_cuda(qp_x, qp_y, crx, cry, xfx, yfx, area_px, area_py,
                  hord: int):
    """(fx, fy) of ``fv_tp_2d`` from the CUDA kernel.

    qp_x, qp_y, crx, cry, xfx, yfx: [F, nz, N, N] float32 on one CUDA
    device.  area_px, area_py: [F, 1, N, N] (plain areas) or [F, nz, N, N]
    (mass-weighted area * delp).
    """
    if hord not in (1, 5, 6, 8):
        raise ValueError(f"unsupported hord {hord}")
    dev = qp_x.device
    if dev.type != "cuda":
        raise ValueError("fv_tp_2d_cuda takes CUDA tensors")
    F, nz, N, _ = qp_x.shape
    field = (F, nz, N, N)
    ptrs = [
        _build.check(t, name, field, dev)
        for t, name in zip(
            (qp_x, qp_y, crx, cry, xfx, yfx),
            ("qp_x", "qp_y", "crx", "cry", "xfx", "yfx"),
        )
    ]
    # the kernel indexes the area with a level stride: 0 for plain areas
    a_shape = (F, 1, N, N) if area_px.shape[1] == 1 else field
    a_kstride = 0 if a_shape[1] == 1 else N * N
    a_fstride = a_shape[1] * N * N
    ptrs += [
        _build.check(area_px, "area_px", a_shape, dev),
        _build.check(area_py, "area_py", a_shape, dev),
    ]
    q_x = torch.empty(field, dtype=torch.float32, device=dev)
    q_y = torch.empty_like(q_x)
    fx = torch.empty_like(q_x)
    fy = torch.empty_like(q_x)
    _build.call(
        "fv3_tp2d", *ptrs, a_fstride, a_kstride, q_x.data_ptr(),
        q_y.data_ptr(), fx.data_ptr(), fy.data_ptr(), F, nz, N, hord,
        _build.stream(),
    )
    fv_tp_2d_cuda.launches += 1
    return fx, fy


fv_tp_2d_cuda.launches = 0


MULTI5_IN = ("dpx", "dpy", "ptx", "pty", "wx", "wy", "dzx", "dzy", "ox",
             "oy", "crx", "cry", "xfx", "yfx", "sfx", "sfy")


def fv_tp_2d_multi5_cuda(dpx, dpy, ptx, pty, wx, wy, dzx, dzy, ox, oy,
                         crx, cry, xfx, yfx, sfx, sfy, area_px, area_py,
                         hord: int):
    """(fxd, fyd, fxt, fyt, fxw, fyw, fxz, fyz, fxo, fyo) of
    ``fv_tp_2d_multi5`` from the CUDA kernel.

    The 16 fields: [F, nz, N, N]; area_px, area_py: [F, N, N]; float32 on
    one CUDA device.
    """
    if hord not in (1, 5, 6, 8):
        raise ValueError(f"unsupported hord {hord}")
    dev = dpx.device
    if dev.type != "cuda":
        raise ValueError("fv_tp_2d_multi5_cuda takes CUDA tensors")
    F, nz, N, _ = dpx.shape
    field = (F, nz, N, N)
    fields = (dpx, dpy, ptx, pty, wx, wy, dzx, dzy, ox, oy,
              crx, cry, xfx, yfx, sfx, sfy)
    ptrs = [_build.check(t, name, field, dev)
            for t, name in zip(fields, MULTI5_IN)]
    ptrs += [_build.check(area_px, "area_px", (F, N, N), dev),
             _build.check(area_py, "area_py", (F, N, N), dev)]
    out = [torch.empty(field, dtype=torch.float32, device=dev)
           for _ in range(10)]

    def array(ts):
        return (ctypes.c_void_p * len(ts))(*ts)

    # two CUDA launches (csrc/tp2d_multi5.cu), no scratch; one count
    _build.call(
        "fv3_tp2d_multi5", array(ptrs), array([t.data_ptr() for t in out]),
        F, nz, N, hord, _build.stream(),
    )
    fv_tp_2d_multi5_cuda.launches += 1
    return tuple(out)


fv_tp_2d_multi5_cuda.launches = 0
