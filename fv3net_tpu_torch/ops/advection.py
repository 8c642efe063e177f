"""Horizontal finite-volume transport operators (fv_tp_2d equivalent).

The 2D flux-form advection scheme of the FV3 dycore: directionally-split
1D PPM operators combined with Lin & Rood (1996) inner/outer averaging so
the splitting error cancels to second order (counterpart of the JAX
package's ``ops/advection.py``).

hord selects the edge reconstruction/limiter:
    1: first-order upwind (piecewise constant)
    5: unlimited PPM (fastest, non-monotone)
    6: PPM with a quasi-monotone (Huynh-style) constraint
    8: strictly monotone PPM (Lin 2004 slope-bounded edges)

All operators work on fully padded cube tensors [6, ..., n+2h, n+2h]
(h >= 3) produced by grid.halo.halo_exchange with the appropriate corner
fill, and return fluxes on the padded face lattice so the Lin-Rood inner
stage can consume halo-row fluxes.  ``fv_tp_2d`` runs the CUDA kernel
(ops/cuda_tp.py) for CUDA tensors and the plain torch form below for CPU
tensors.  ``fv_tp_2d_multi5`` is the D stage's five transports in one
call (the fused kernel of ops/cuda_tp.py for CUDA tensors), taken by the
dycore substep when ``set_fused_transport(True)``.
"""

from __future__ import annotations

import torch

# The JAX package's switch for the fused 5-field substep transport
# (its ops/advection.py:51-68), with the same default: off.
_USE_FUSED5 = False


def set_fused_transport(flag):
    """Enable (True) / disable (False) the fused 5-field transport in the
    dycore substep (``fv_tp_2d_multi5``)."""
    global _USE_FUSED5
    _USE_FUSED5 = bool(flag)


def _fused5_enabled() -> bool:
    return _USE_FUSED5


def _ppm_edges(q, axis: int, hord: int):
    """Left/right edge values and curvature per cell along `axis`.

    Cells within 2 of the array boundary get garbage (consumed only if
    the caller's halo is too small -- callers must pass h >= 3).
    Returns (al, ar, a6) with al[i] the edge value between cells i-1,i.
    """

    def sh(k):
        return torch.roll(q, -k, dims=axis)

    qm2, qm1, q0, qp1 = sh(-2), sh(-1), q, sh(1)
    if hord == 1:
        return q0, q0, torch.zeros_like(q0)

    # uniform 4th-order edge interpolation (FV3 tp_core coefficients)
    al = (7.0 / 12.0) * (qm1 + q0) - (1.0 / 12.0) * (qm2 + qp1)
    ar = torch.roll(al, -1, dims=axis)  # al of cell i+1 = right edge of i

    if hord == 5:
        a6 = 3.0 * (2.0 * q0 - (al + ar))
        return al, ar, a6

    lo = torch.minimum(torch.minimum(qm1, q0), qp1)
    hi = torch.maximum(torch.maximum(qm1, q0), qp1)
    if hord == 8:
        # strictly monotone: edge increments bounded by the limited slope
        df2 = 0.25 * (qp1 - qm1)
        dm = torch.sign(df2) * torch.minimum(
            torch.abs(2.0 * df2),
            torch.minimum(torch.abs(hi - q0), torch.abs(q0 - lo)),
        )
        bl = -torch.sign(dm) * torch.minimum(
            torch.abs(2.0 * dm), torch.abs(al - q0)
        )
        br = torch.sign(dm) * torch.minimum(
            torch.abs(2.0 * dm), torch.abs(ar - q0)
        )
        al8 = q0 + bl
        ar8 = q0 + br
        a6 = 3.0 * (2.0 * q0 - (al8 + ar8))
        return al8, ar8, a6

    if hord == 6:
        # quasi-monotone: clamp edges into the local neighborhood range
        al6 = torch.minimum(torch.maximum(al, lo), hi)
        ar6 = torch.minimum(torch.maximum(ar, lo), hi)
        a6 = 3.0 * (2.0 * q0 - (al6 + ar6))
        return al6, ar6, a6

    raise ValueError(f"unsupported hord {hord}")


def ppm_flux(q, cr, axis: int, hord: int):
    """Upwind PPM face-average of q for Courant numbers cr.

    q: padded cell array; cr: Courant number AT THE FACE between cells
    i-1 and i, stored at index i of an array the same length as q along
    `axis` (entry 0 invalid).  Returns the face average (the "advected
    q" to be multiplied by a mass flux), same shape as q, entry i =
    value at face i (between cells i-1 and i); entries near the array
    ends are garbage.
    """
    al, ar, a6 = _ppm_edges(q, axis, hord)

    def sh(a, k):
        return torch.roll(a, -k, dims=axis)

    # face i: upwind cell i-1 when cr > 0 (flow toward +axis), else cell i
    c = cr
    arm = sh(ar, -1)
    alm = sh(al, -1)
    a6m = sh(a6, -1)
    qup = arm - 0.5 * c * (
        (arm - alm) - a6m * (1.0 - (2.0 / 3.0) * c)
    )
    b = -c
    qdn = al + 0.5 * b * ((ar - al) + a6 * (1.0 - (2.0 / 3.0) * b))
    return torch.where(c > 0.0, qup, qdn)


def fv_tp_2d(qp_x, qp_y, crx, cry, xfx, yfx, area_px, area_py, hord: int):
    """2D Lin-Rood flux-form transport on the padded cube.

    Args:
        qp_x: q padded with fill='x' corners (consumed by x-stencils)
        qp_y: q padded with fill='y' corners (consumed by y-stencils)
        crx: Courant numbers at x-faces, padded face lattice: entry
            [..., j, i] = face between cells (j, i-1) and (j, i)
        cry: Courant numbers at y-faces (same convention along axis -2)
        xfx: mass flux through x-faces; the flux returned is
            `face-average(q) * xfx`
        yfx: mass flux through y-faces
        area_px: padded cell areas, corner fill 'x' ([F, N, N],
            [F, 1, N, N], or the mass-weighted [F, nz, N, N])
        area_py: padded cell areas, corner fill 'y'
        hord: reconstruction order/limiter

    Returns:
        (fx, fy): mass-weighted q fluxes on the padded face lattices,
        valid on the faces the caller consumes ([2, N-2) and inward).

    CUDA tensors go to the hand-written kernel (ops/cuda_tp.py), CPU
    tensors to the plain form below.
    """
    if qp_x.is_cuda:
        from .cuda_tp import fv_tp_2d_cuda

        return fv_tp_2d_cuda(
            qp_x.contiguous(), qp_y.contiguous(), crx.contiguous(),
            cry.contiguous(), xfx.contiguous(), yfx.contiguous(),
            area_px.contiguous(), area_py.contiguous(), hord,
        )
    return fv_tp_2d_plain(
        qp_x, qp_y, crx, cry, xfx, yfx, area_px, area_py, hord
    )


def fv_tp_2d_plain(qp_x, qp_y, crx, cry, xfx, yfx, area_px, area_py,
                   hord: int):
    """The plain torch form of fv_tp_2d (any device)."""

    def shx(a, k):
        return torch.roll(a, -k, dims=-1)

    def shy(a, k):
        return torch.roll(a, -k, dims=-2)

    # inner HALF update in the transverse direction -> outer fluxes; the
    # half factor is what cancels the splitting cross-term to second
    # order and keeps the 2-delta modes neutral (Lin & Rood 1996)
    fy2 = ppm_flux(qp_y, cry, -2, hord) * yfx
    ra_y = area_py + (yfx - shy(yfx, 1))
    q_y = 0.5 * (qp_y + (qp_y * area_py + (fy2 - shy(fy2, 1))) / ra_y)

    fx2 = ppm_flux(qp_x, crx, -1, hord) * xfx
    ra_x = area_px + (xfx - shx(xfx, 1))
    q_x = 0.5 * (qp_x + (qp_x * area_px + (fx2 - shx(fx2, 1))) / ra_x)

    fx = ppm_flux(q_y, crx, -1, hord) * xfx
    fy = ppm_flux(q_x, cry, -2, hord) * yfx
    return fx, fy


def fv_tp_2d_multi5(dpx, dpy, ptx, pty, wx, wy, dzx, dzy, ox, oy,
                    crx, cry, xfx, yfx, sfx, sfy, area_px, area_py,
                    hord: int):
    """The D stage's five transports in one call.

    Returns (fxd, fyd, fxt, fyt, fxw, fyw, fxz, fyz, fxo, fyo): fv_tp_2d
    of delp and delz with (xfx, yfx, area), of pt and w with the delp
    fluxes (fxd, fyd) and the air mass area * delp, and of the vorticity
    with (sfx, sfy, area).  Fields are padded [F, nz, N, N]; areas
    [F, N, N] or [F, 1, N, N].  CUDA tensors go to the fused kernel
    (ops/cuda_tp.py), CPU tensors to the plain form.
    """
    args = (dpx, dpy, ptx, pty, wx, wy, dzx, dzy, ox, oy,
            crx, cry, xfx, yfx, sfx, sfy)
    F, N = dpx.shape[0], dpx.shape[-1]
    if dpx.is_cuda:
        from .cuda_tp import fv_tp_2d_multi5_cuda

        return fv_tp_2d_multi5_cuda(
            *(a.contiguous() for a in args),
            area_px.reshape(F, N, N).contiguous(),
            area_py.reshape(F, N, N).contiguous(), hord,
        )
    return fv_tp_2d_multi5_plain(*args, area_px, area_py, hord)


def fv_tp_2d_multi5_plain(dpx, dpy, ptx, pty, wx, wy, dzx, dzy, ox, oy,
                          crx, cry, xfx, yfx, sfx, sfy, area_px, area_py,
                          hord: int):
    """The plain form of fv_tp_2d_multi5: five fv_tp_2d_plain calls in
    the fused wiring."""
    return transports5(
        fv_tp_2d_plain, dpx, dpy, ptx, pty, wx, wy, dzx, dzy, ox, oy,
        crx, cry, xfx, yfx, sfx, sfy, area_px, area_py, hord,
    )


def transports5(tp, dpx, dpy, ptx, pty, wx, wy, dzx, dzy, ox, oy,
                crx, cry, xfx, yfx, sfx, sfy, area_px, area_py, hord: int):
    """The D stage's five transports as five calls of the transport `tp`
    (fv_tp_2d or one of its implementations), wired as the JAX package's
    dycore/hydro.py:423-452 wires them: delp and delz with (xfx, yfx,
    area); pt and w mass-weighted with the delp fluxes -- the Lin-Rood
    inner update divides by the transversely updated AIR MASS area * delp
    -- and the vorticity with (sfx, sfy, area).  Returns the fluxes in
    fv_tp_2d_multi5's order."""
    F, N = dpx.shape[0], dpx.shape[-1]
    apx = area_px.reshape(F, 1, N, N)
    apy = area_py.reshape(F, 1, N, N)
    fxd, fyd = tp(dpx, dpy, crx, cry, xfx, yfx, apx, apy, hord)
    adpx, adpy = apx * dpx, apy * dpy
    return (
        fxd, fyd,
        *tp(ptx, pty, crx, cry, fxd, fyd, adpx, adpy, hord),
        *tp(wx, wy, crx, cry, fxd, fyd, adpx, adpy, hord),
        *tp(dzx, dzy, crx, cry, xfx, yfx, apx, apy, hord),
        *tp(ox, oy, crx, cry, sfx, sfy, apx, apy, hord),
    )
