"""Semi-implicit nonhydrostatic vertical solver (Riemann solver).

Counterpart of the JAX package's ``dycore/riemann.py`` (FV3's
`Riem_Solver3`/`SIM1_solver`, configured fully implicit by `a_imp: 1.0`
and `hydrostatic: false` in the reference C12 namelist).  It advances
vertically propagating sound waves implicitly so the acoustic substep dt
is not limited by the vertical CFL.

Column system (k index increasing downward, w positive up, delz < 0 by
the FV3 restart convention):

    dm * dw/dt = p'(below) - p'(above)          (perturbation force)
    d(delz)/dt = w(top i/f) - w(bottom i/f)     (compression)
    p_full     = p0 * (-dm R theta_v / (delz p0))**gamma   (gas law)
    p'         = p_full - p_hydro

Backward-Euler linearization couples neighboring layers through the
interface stiffness aa_k = 2 gamma dt^2 (p_if)/ (dz_{k-1}+dz_k), giving
one bidiagonal solve for the provisional interface perturbation and one
tridiagonal (Thomas) solve for w.  The plain form below loops over levels
in Python with all columns batched per step; ``sim1_solve`` runs the CUDA
kernel (ops/cuda_sim1.py, column slabs in shared memory) for CUDA
tensors.

Boundary conditions: p' = 0 at the model top (open); at the surface the
material boundary condition w = ws (terrain-following surface vertical
motion, ws = V . grad(z_s)).
"""

from __future__ import annotations

import torch

from ..constants import (
    CP_AIR,
    CV_AIR,
    GRAV,
    RDGAS,
    REFERENCE_SURFACE_PRESSURE as P00,
)

GAMMA = CP_AIR / CV_AIR


def full_pressure(dm, pt, dz):
    """Ideal-gas full pressure from mass, theta_v, and (negative) dz."""
    rho_rtheta = -dm * RDGAS * pt / dz  # > 0 since dz < 0
    return P00 * (rho_rtheta / P00) ** GAMMA


def dz_from_pressure(dm, pt, p):
    """Invert the gas law: (negative) layer thickness at pressure p."""
    return -(dm * RDGAS * pt / P00) * (p / P00) ** (-CV_AIR / CP_AIR)


def sim1_solve(dt, dm, pt, dz, w, pem, pm, ws, p_fac: float = 0.05,
               halo: int = 0):
    """Dispatching front-end: the CUDA kernel for CUDA tensors, the
    plain form below for CPU tensors.

    dm, pt, dz, w are [6, nz, n, n]; pem, pm and ws may carry a halo of
    `halo` cells around their n x n interior ([6, nz+1, N, N], [6, nz,
    N, N], [6, N, N] with N = n + 2 halo), which is what the solve reads:
    the kernel through the row stride N, without a copy.
    """
    if dm.is_cuda:
        from ..ops.cuda_sim1 import sim1_solver_cuda

        return sim1_solver_cuda(
            dt, dm.contiguous(), pt.contiguous(), dz.contiguous(),
            w.contiguous(), pem.contiguous(), pm.contiguous(),
            ws.contiguous(), p_fac=p_fac, halo=halo,
        )
    if halo:
        inner = slice(halo, -halo)
        pem, pm = pem[..., inner, inner], pm[..., inner, inner]
        ws = ws[..., inner, inner]
    return sim1_solver(dt, dm, pt, dz, w, pem, pm, ws, p_fac)


def sim1_solver(dt, dm, pt, dz, w, pem, pm, ws, p_fac: float = 0.05):
    """Fully implicit vertical acoustic solve for one substep.

    All arrays have the level axis at position 1: dm/pt/dz/w/pm are
    [6, nz, n, n] (or any [B, nz, ...]), pem is [6, nz+1, n, n]
    hydrostatic interface pressure, ws is [6, n, n].

    Returns (w2, dz2, ppe) with ppe the updated nonhydrostatic interface
    pressure perturbation [6, nz+1, n, n] (zero at the top).
    """
    nz = dm.shape[1]
    dm_l, pt_l, dz_l, w_l = (a.movedim(1, 0) for a in (dm, pt, dz, w))
    pem_l, pm_l = pem.movedim(1, 0), pm.movedim(1, 0)

    # layer pressure perturbation from the gas law
    pe_l = full_pressure(dm_l, pt_l, dz_l) - pm_l  # [nz, ...]

    # --- provisional interface perturbation (parabolic reconstruction,
    # forward elimination as in SIM1): rows couple (pp_k, pp_{k+1}) ----
    g_rat = dm_l[:-1] / dm_l[1:]  # [nz-1, ...]
    zero = torch.zeros_like(pe_l[0])
    pp = [zero]
    bet = None
    for k in range(nz):
        if k < nz - 1:
            bb = 2.0 * (1.0 + g_rat[k])
            dd = 3.0 * (pe_l[k] + g_rat[k] * pe_l[k + 1])
        else:
            bb = 2.0 * torch.ones_like(zero)
            dd = 3.0 * pe_l[k]
        bet = bb if k == 0 else bb - g_rat[k - 1] / bet
        pp.append((dd - pp[k]) / bet)

    # --- implicit w (Thomas algorithm) --------------------------------
    t1g = 2.0 * GAMMA * dt * dt
    # interface stiffness at interfaces 1..nz-1 (dz < 0 so aa < 0), and
    # the bottom half-layer stiffness (surface reaction)
    aa = [
        t1g / (dz_l[k - 1] + dz_l[k]) * (pem_l[k] + pp[k])
        for k in range(1, nz)
    ]
    p1 = t1g / dz_l[-1] * (pem_l[-1] + pp[-1])
    a_up = [zero] + aa
    a_dn = aa + [p1]
    wp, gam = [], []
    for k in range(nz):
        r = dm_l[k] * w_l[k] + dt * (pp[k + 1] - pp[k])
        if k == nz - 1:
            r = r + (-p1 * ws)
        if k == 0:
            g = zero
            bet = dm_l[k] - a_dn[k]
            wp.append((r - a_up[k] * zero) / bet)
        else:
            g = a_up[k] / bet
            bet = dm_l[k] - (a_up[k] + a_dn[k] + a_up[k] * g)
            wp.append((r - a_up[k] * wp[k - 1]) / bet)
        gam.append(g)
    w2 = [None] * nz
    w_next = zero
    for k in range(nz - 1, -1, -1):
        g_next = gam[k + 1] if k < nz - 1 else zero
        w_next = wp[k] - g_next * w_next
        w2[k] = w_next
    w2 = torch.stack(w2)

    # --- updated interface perturbation and new layer thickness -------
    dpe = dm_l * (w2 - w_l) / dt
    ppe = torch.cat([zero[None], torch.cumsum(dpe, dim=0)], dim=0)
    p_lay = pm_l + (ppe[:-1] + 2.0 * ppe[1:]) / 3.0
    p_lay = torch.maximum(p_lay, p_fac * pm_l)
    dz2 = dz_from_pressure(dm_l, pt_l, p_lay)

    return w2.movedim(0, 1), dz2.movedim(0, 1), ppe.movedim(0, 1)


def hydrostatic_dz(delp, pt, pe):
    """delz in exact discrete hydrostatic balance (rest-state init).

    delp [.., nz, ..], pt theta_v, pe interface pressures [.., nz+1, ..]
    with level axis 1.  Uses dz = -(R theta / g) * pi-layer-mean * dlnp
    consistency: p_full(dz) == layer-mean hydrostatic pressure.
    """
    pm = layer_mean_pressure(delp, pe)
    dm = delp / GRAV
    return dz_from_pressure(dm, pt, pm)


def layer_mean_pressure(delp, pe):
    """Exact mass-weighted layer pressure dp/dlnp (FV3's pm2)."""
    return delp / (torch.log(pe[:, 1:]) - torch.log(pe[:, :-1]))
