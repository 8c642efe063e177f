"""Nonhydrostatic FV3-style dynamical core: Lagrangian layers + remap.

Counterpart of the JAX package's ``dycore/hydro.py`` for the path its
benchmark runs (``make_dycore_stepper`` with the c_sw/d_sw substep, the
nonhydrostatic semi-implicit vertical solve, tracer transport and the
conservative vertical remap), face level, in PyTorch.  The shallow-water
machinery of sw.py is applied per Lagrangian layer with a theta-pi
pressure-gradient force, n_split acoustic-style substeps, accumulated
mass fluxes for tracer transport, and a conservative PPM vertical remap
(ops.remap) back to the hybrid ak/bk coordinate every k_split step.

Prognostic state (all [6, nz, ...] with D-grid staggering):
    delp  [6, nz, n, n]     layer pressure thickness (Pa)
    pt    [6, nz, n, n]     virtual potential temperature (K)
    u     [6, nz, n+1, n]   covariant x-wind on x-edges
    v     [6, nz, n, n+1]
    q     [ntracer, 6, nz, n, n]  tracer mixing ratios (optional)
    w     [6, nz, n, n]     vertical wind (m/s)
    delz  [6, nz, n, n]     layer thickness (m, < 0)

On CUDA tensors the hand-written kernels run: the transports
(ops/cuda_tp.py; the five D-stage transports as one fused kernel when
``ops.advection.set_fused_transport(True)``), the vertical solve
(ops/cuda_sim1.py), the del-4 filters (ops/cuda_filter.py), the column
pressure chains (ops/cuda_column.py) and the vertical remap
(ops/cuda_remap.py).  On CPU tensors every piece runs its plain torch
form.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import (
    CP_AIR,
    GRAV,
    KAPPA,
    REFERENCE_SURFACE_PRESSURE,
)
from ..device import default_device
from ..grid.geometry import CubedSphereGrid
from ..grid.halo import (
    average_dgrid_boundary,
    edge_pad,
    extend_cells_one,
    halo_exchange,
    halo_exchange_dgrid,
)
from ..ops.advection import (
    _fused5_enabled,
    fv_tp_2d,
    fv_tp_2d_multi5,
    ppm_flux,
    transports5,
)
from ..ops.cuda_column import column_pressures
from ..ops.remap import remap_levels
from .riemann import hydrostatic_dz, sim1_solve
from .sw import (
    CORNER_DAMP_COEF,
    FILTER_COEF,
    VORT_DAMP_COEF,
    SWMetrics,
    _c_half_winds_common,
    _finish_c_half,
    _masked_vertex_set,
    _shx,
    _shy,
    corner_div_damp,
    div_damp,
    padded_cgrid_winds,
    scalar_filter,
    vort_damp,
)


class DycoreState(NamedTuple):
    delp: torch.Tensor
    pt: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    q: Optional[torch.Tensor] = None  # [ntracer, 6, nz, n, n]
    # nonhydrostatic prognostics (reference namelist `hydrostatic: false`);
    # delz < 0 by the FV3 restart convention
    w: Optional[torch.Tensor] = None  # [6, nz, n, n] vertical wind (m/s)
    delz: Optional[torch.Tensor] = None  # [6, nz, n, n] thickness (m)


def hybrid_coefficients(nz: int, ptop: float = 300.0):
    """Hybrid sigma-p coefficients: pe = ak + bk * ps (float64 CPU tensors).

    The Jablonowski & Williamson (2006) / DCMIP hybrid definition (the
    JAX package's default): eta levels from eta_top = ptop/p0 to 1 with a
    power-law stretch (1.4) clustering resolution near the surface,
    bk = (eta - 0.2)/(1 - 0.2) below the transition eta = 0.2 and 0 above
    it (FV3's `ks` pure-pressure top layers), ak = p0*(eta - bk).
    """
    transition_eta, stretch = 0.2, 1.4
    p0 = REFERENCE_SURFACE_PRESSURE
    eta_top = ptop / p0
    s = np.linspace(0.0, 1.0, nz + 1)
    eta = eta_top + (1.0 - eta_top) * s ** stretch
    bk = np.where(
        eta > transition_eta,
        (eta - transition_eta) / (1.0 - transition_eta),
        0.0,
    )
    bk[-1] = 1.0
    ak = p0 * (eta - bk)
    ak[-1] = 0.0
    # interfaces must stay monotone down to mountain-top surface pressures
    for ps in (45000.0, 101300.0):
        if not (np.diff(ak + bk * ps) > 0).all():
            raise ValueError(
                f"non-monotone hybrid coordinate for ps={ps}, ptop={ptop}"
            )
    return torch.as_tensor(ak), torch.as_tensor(bk)


def _interface_pressures(delp, ptop: float):
    """ptop + prefix sum of delp over levels: [6, nz+1, ...]."""
    return ptop + torch.cat(
        [torch.zeros_like(delp[:, :1]), torch.cumsum(delp, dim=1)], dim=1
    )


def rest_state(n: int, nz: int, ptop: float = 300.0, dtype=torch.float32,
               device=None) -> DycoreState:
    """Hydrostatic rest state on the hybrid coordinate: surface pressure
    1e5 Pa, theta from a 285 K isothermal-Exner profile, zero winds and
    one zero tracer (the JAX package's benchmark state,
    ``__graft_entry__._rest_state``; w and delz not attached).  On the
    CUDA device unless `device` says otherwise."""
    if device is None:
        device = default_device("rest_state")
    ak, bk = (c.numpy() for c in hybrid_coefficients(nz, ptop))
    pe = ak[:, None, None] + bk[:, None, None] * 1e5
    pik = (pe / REFERENCE_SURFACE_PRESSURE) ** KAPPA
    theta = 285.0 / (0.5 * (pik[1:] + pik[:-1]))

    def field(a):
        return torch.as_tensor(
            np.broadcast_to(a, (6, nz, n, n)).astype(np.float32)
        ).to(dtype=dtype, device=device)

    zeros = dict(dtype=dtype, device=device)
    return DycoreState(
        field(pe[1:] - pe[:-1]),
        field(theta),
        torch.zeros((6, nz, n + 1, n), **zeros),
        torch.zeros((6, nz, n, n + 1), **zeros),
        torch.zeros((1, 6, nz, n, n), **zeros),
    )


def benchmark_state(n: int, nz: int, ptop: float = 300.0, device=None,
                    seed: int = 0) -> DycoreState:
    """The JAX package benchmark's initial state (bench.py
    ``_build_config``): the f32 rest state plus a seeded unit-normal pt
    perturbation, with w = 0 and hydrostatic delz, built on the CPU and
    moved to `device` (the CUDA device unless the caller names one)."""
    if device is None:
        device = default_device("benchmark_state")
    st = rest_state(n, nz, ptop, torch.float32, "cpu")
    noise = np.random.RandomState(seed).randn(*st.pt.shape)
    st = st._replace(pt=st.pt + torch.as_tensor(noise.astype(np.float32)))
    st = add_nonhydrostatic_fields(st, ptop)
    return DycoreState(*(x.to(device) for x in st))


def add_nonhydrostatic_fields(state: DycoreState, ptop: float):
    """Attach w=0 and hydrostatically balanced delz to a state."""
    pe = _interface_pressures(state.delp, ptop)
    delz = hydrostatic_dz(state.delp, state.pt, pe)
    return state._replace(w=torch.zeros_like(state.delp), delz=delz)


def _corner_avg(phi):
    """Cell-centered [.., N, N] -> corner lattice [.., N+1, N+1]."""
    pe = edge_pad(phi, 1)
    return 0.25 * (
        pe[..., :-1, :-1] + pe[..., :-1, 1:] + pe[..., 1:, :-1]
        + pe[..., 1:, 1:]
    )


def _vertex_fix_scalar_corner(arr_c, vals3, h, n):
    """Replace cube-corner vertex entries of a corner-lattice array."""
    hn = h + n
    for (cj, ci), v3 in zip(((h, h), (h, hn), (hn, h), (hn, hn)), vals3):
        arr_c = _masked_vertex_set(arr_c, (cj, ci), v3)
    return arr_c


def _vertex_cells(phi, h, n):
    """3-real-cell means at the 4 cube-corner vertices of a padded
    cell-centered field (same convention as sw.py)."""
    hn = h + n
    spec = (
        ((h - 1, h), (h, h - 1), (h, h)),
        ((h - 1, hn - 1), (h, hn), (h, hn - 1)),
        ((hn, h), (hn - 1, h), (hn - 1, h - 1)),
        ((hn, hn - 1), (hn - 1, hn), (hn - 1, hn - 1)),
    )
    return [
        sum(phi[..., j, i] for j, i in cells) / 3.0 for cells in spec
    ]


def _geopotential(dphi, phis_p):
    """Interface geopotential integrated upward from the surface
    (Phi_if[nz] = phis) and its layer means."""
    phi_if_rev = torch.cat(
        [torch.zeros_like(dphi[:, :1]),
         torch.cumsum(torch.flip(dphi, dims=[1]), dim=1)], dim=1
    )
    phi_if = torch.flip(phi_if_rev, dims=[1]) + phis_p
    return 0.5 * (phi_if[:, 1:] + phi_if[:, :-1])


def _c_sw_half_3d(state: DycoreState, m: SWMetrics, dt2: float,
                  ptop: float, phis, up, vp, dpx, dpy, ptx, pty):
    """FV3 ``c_sw`` role, 3D form: a cheap C-grid half step.

    Advances delp/pt by dt2 with 1st-order upwind fluxes and the C
    winds by dt2 with a forward-backward momentum update (absolute
    vorticity x tangential wind + cell-KE, Exner-form PGF and
    hydrostatic geopotential gradients from the half-updated mass
    field), producing time-centered ADVECTIVE winds for the full D
    stage.  The half-stage PGF is hydrostatic even in nonhydrostatic
    runs.
    """
    uc, vc, vc_on_x, uc_on_y = padded_cgrid_winds(
        state.u, state.v, m, up, vp
    )
    bc, ke, rarea_p, zf_u, zf_v, vbar_u, ubar_v = _c_half_winds_common(
        uc, vc, vc_on_x, uc_on_y, up, vp, m
    )
    # upwind half-step mass/heat transport on the padded lattice
    # (interior + edge bands valid; corner blocks never consumed)
    fx = ppm_flux(dpx, uc, -1, 1) * (uc * dt2 * bc(m.dy_fs))
    fy = ppm_flux(dpy, vc, -2, 1) * (vc * dt2 * bc(m.dx_fs))
    div = (fx - _shx(fx, 1)) + (fy - _shy(fy, 1))
    delpc = dpx + div * rarea_p
    fxt = ppm_flux(ptx, uc, -1, 1) * fx
    fyt = ppm_flux(pty, vc, -2, 1) * fy
    divt = (fxt - _shx(fxt, 1)) + (fyt - _shy(fyt, 1))
    ptc = (ptx * dpx + divt * rarea_p) / delpc

    # Exner + hydrostatic geopotential of the half-updated columns.  The
    # unused halo-corner columns of the padded delpc may hold garbage:
    # the kernel branch (CUDA) guards the Exner power with pe >= 1e-30,
    # the plain branch (CPU) does not -- both exactly as the JAX package's
    # kernel and jnp branches
    pe, pi_lay, _ = column_pressures(delpc, ptop)
    if delpc.is_cuda:
        pe = torch.clamp_min(pe, 1e-30)
    pik = (pe / REFERENCE_SURFACE_PRESSURE) ** KAPPA
    dphi = CP_AIR * ptc * (pik[:, 1:] - pik[:, :-1])
    phis_p = (
        halo_exchange(phis, m.halo, fill="x")[:, None]
        if phis is not None else 0.0
    )
    kphi = ke + _geopotential(dphi, phis_p)

    ptf_u = 0.5 * (ptc + _shx(ptc, -1))
    ptf_v = 0.5 * (ptc + _shy(ptc, -1))
    duc = dt2 * (
        zf_u * vbar_u
        - (
            (kphi - _shx(kphi, -1))
            + CP_AIR * ptf_u * (pi_lay - _shx(pi_lay, -1))
        ) / bc(m.dxc_f)
    )
    dvc = dt2 * (
        -zf_v * ubar_v
        - (
            (kphi - _shy(kphi, -1))
            + CP_AIR * ptf_v * (pi_lay - _shy(pi_lay, -1))
        ) / bc(m.dyc_f)
    )
    return _finish_c_half(uc, vc, duc, dvc, m)


def dyn_substep(state: DycoreState, m: SWMetrics, dt: float, ptop: float,
                hord: int, d2_damp: float, phis,
                mfx_acc, mfy_acc, cx_acc, cy_acc,
                midpoint: bool = True, c_half: bool = True):
    """One acoustic-style substep on the Lagrangian layers, with
    time-centered advective winds from the cheap C-grid half-stage
    (``_c_sw_half_3d``, FV3's c_sw role); the D stage runs once from the
    time-n state.  Only this (midpoint, c_half) scheme is ported.

    Returns (new_state_without_tracers, accumulated fluxes).
    """
    if not (midpoint and c_half):
        raise NotImplementedError(
            "only the midpoint c_sw/d_sw substep (midpoint=True, "
            "c_half=True) is ported"
        )
    h = m.halo
    up, vp = halo_exchange_dgrid(state.u, state.v, h)
    dpx = halo_exchange(state.delp, h, fill="x")
    dpy = halo_exchange(state.delp, h, fill="y")
    ptx = halo_exchange(state.pt, h, fill="x")
    pty = halo_exchange(state.pt, h, fill="y")
    adv = _c_sw_half_3d(
        state, m, 0.5 * dt, ptop, phis, up, vp, dpx, dpy, ptx, pty
    )
    new, (fx, fy, crx, cry) = _substep_core(
        state, m, dt, ptop, hord, d2_damp, phis,
        exch=(up, vp, dpx, dpy, ptx, pty), adv=adv,
    )
    if mfx_acc is None:  # tracer-free run: no accumulation carried
        return new, (None, None, None, None)
    return new, (mfx_acc + fx, mfy_acc + fy, cx_acc + crx, cy_acc + cry)


def _substep_core(base: DycoreState, m: SWMetrics, dt: float, ptop: float,
                  hord: int, d2_damp: float, phis, exch, adv):
    """Flux-form update of `base` (the nonhydrostatic D stage).

    exch: the (up, vp, dpx, dpy, ptx, pty) halo exchanges of base's
    fields (shared with the C half-stage).  adv: the (uc, vc) padded
    time-centered advective C winds from the half-stage.

    w is transported mass-weighted and delz volume-weighted alongside the
    other prognostics, the semi-implicit Riemann solver (riemann.py)
    advances the vertical acoustics, the geopotential in the wind update
    comes from the TRUE layer heights (delz), and the winds get the
    perturbation-pressure gradient -(1/rho) grad_s(p') on top of the
    hydrostatic cp*theta*grad(pi) term.
    """
    if base.w is None:
        raise NotImplementedError(
            "only the nonhydrostatic substep (state with w, delz) is ported"
        )
    h, n = m.halo, m.n
    u, v = base.u, base.v
    up, vp, dpx, dpy, ptx, pty = exch
    uc, vc = adv

    crx = uc * dt / m.dxc_f[:, None]
    cry = vc * dt / m.dyc_f[:, None]
    xfx = uc * dt * m.dy_fs[:, None]
    yfx = vc * dt * m.dx_fs[:, None]

    # absolute vorticity (cell centered, padded) and its flux widths
    udx = u * m.dx_u[:, None, h : h + n + 1, h : h + n]
    vdy = v * m.dy_v[:, None, h : h + n, h : h + n + 1]
    vort = (
        udx[:, :, :-1, :] - udx[:, :, 1:, :]
        + vdy[:, :, :, 1:] - vdy[:, :, :, :-1]
    )
    zeta_int = vort * m.rarea[:, None]
    omega_x = halo_exchange(zeta_int, h, fill="x") + m.f_px[:, None]
    omega_y = halo_exchange(zeta_int, h, fill="y") + m.f_py[:, None]
    sfx = uc * dt * m.sina_u[:, None]
    sfy = vc * dt * m.sina_v[:, None]

    # the five transports (ops.advection.transports5): fused into one
    # call when the switch is on (the JAX package's fused branch, without
    # its 128-lane gate), else five fv_tp_2d calls
    wx = halo_exchange(base.w, h, fill="x")
    wy = halo_exchange(base.w, h, fill="y")
    dzx = halo_exchange(base.delz, h, fill="x")
    dzy = halo_exchange(base.delz, h, fill="y")
    args = (dpx, dpy, ptx, pty, wx, wy, dzx, dzy, omega_x, omega_y, crx,
            cry, xfx, yfx, sfx, sfy, m.area_px, m.area_py, hord)
    (fx, fy, fxt, fyt, fxw, fyw, fxz, fyz, fxo, fyo) = (
        fv_tp_2d_multi5(*args) if _fused5_enabled()
        else transports5(fv_tp_2d, *args)
    )

    def flux_div(fx_, fy_):
        d = (fx_ - _shx(fx_, 1)) + (fy_ - _shy(fy_, 1))
        return d[:, :, h : h + n, h : h + n] * m.rarea[:, None]

    fc = FILTER_COEF if d2_damp != 0.0 else 0.0
    delp_new = scalar_filter(base.delp + flux_div(fx, fy), m, fc)
    pt_new = scalar_filter(
        base.pt * base.delp + flux_div(fxt, fyt), m, fc
    ) / delp_new
    # w: mass-weighted (like pt); delz: volume-form with the area fluxes
    # (conserves total volume)
    w_adv = scalar_filter(
        base.w * base.delp + flux_div(fxw, fyw), m, fc
    ) / delp_new
    dz_adv = scalar_filter(base.delz + flux_div(fxz, fyz), m, fc)

    # --- kinetic energy + PGF at corners ---------------------------------
    ub = 0.5 * (_shx(up, -1) + up)
    vb = 0.5 * (_shy(vp, -1) + vp)
    ubp = torch.nn.functional.pad(ub, (0, 1))
    vbp = torch.nn.functional.pad(vb, (0, 0, 0, 1))
    # |V|^2 = (u1^2 + u2^2 - 2 cosa u1 u2) / sin^2 (covariant metric)
    ke_c = 0.5 * (
        ubp ** 2 + vbp ** 2
        - 2.0 * m.cosa_b[:, None] * ubp * vbp
    ) * m.rsin2_b[:, None]
    hn = h + n
    vert_edges = (
        ((h, h), ((up, h, h), (vp, h, h), (vp, h - 1, h))),
        ((h, hn), ((up, h, hn - 1), (vp, h, hn), (vp, h - 1, hn))),
        ((hn, h), ((up, hn, h), (vp, hn - 1, h), (vp, hn, h))),
        ((hn, hn), ((up, hn, hn - 1), (vp, hn - 1, hn), (vp, hn, hn))),
    )
    for (cj, ci), es in vert_edges:
        a, b, c = (arr[:, :, j, i] for arr, j, i in es)
        ke_c = _masked_vertex_set(
            ke_c, (cj, ci), (a * a + b * b + c * c) / 3.0
        )

    # hydrostatic pressure and Exner function on the NEW mass field
    # (forward-backward coupling), all on fill='y' padded fields
    dp_p = halo_exchange(delp_new, h, fill="y")
    pt_p = halo_exchange(pt_new, h, fill="y")
    pe_p, pi_lay, pm_p = column_pressures(dp_p, ptop)
    phis_p = (
        halo_exchange(phis, h, fill="y")[:, None]
        if phis is not None
        else 0.0
    )
    # vertical acoustics: semi-implicit solve on the transported state
    # (Riem_Solver3 position in fv_dynamics), then the TRUE geopotential
    # from the solved layer heights
    pe_int = pe_p[:, :, h : h + n, h : h + n]
    pm_int = pm_p[:, :, h : h + n, h : h + n]
    dm_int = delp_new / GRAV
    if phis is not None:
        # terrain BC: ws = V . grad(z_s) from bottom-level C-winds
        zs = phis / GRAV
        zsx = halo_exchange(zs, h, fill="x")
        zsy = halo_exchange(zs, h, fill="y")
        dzdx_f = (zsx - _shx(zsx, -1)) / m.dxc_f
        dzdy_f = (zsy - _shy(zsy, -1)) / m.dyc_f
        ucb, vcb = uc[:, -1], vc[:, -1]
        ws_full = 0.5 * (
            ucb * dzdx_f + _shx(ucb * dzdx_f, 1)
            + vcb * dzdy_f + _shy(vcb * dzdy_f, 1)
        )
        ws = ws_full[:, h : h + n, h : h + n]
    else:
        ws = torch.zeros_like(delp_new[:, 0])
    w2, dz2, ppe = sim1_solve(
        dt, dm_int, pt_new, dz_adv, w_adv, pe_int, pm_int, ws
    )
    dz_p = halo_exchange(dz2, h, fill="y")
    phi_lay = _geopotential(-GRAV * dz_p, phis_p)  # dphi positive downward

    phi_c = _vertex_fix_scalar_corner(
        _corner_avg(phi_lay), _vertex_cells(phi_lay, h, n), h, n
    )
    pi_c = _vertex_fix_scalar_corner(
        _corner_avg(pi_lay), _vertex_cells(pi_lay, h, n), h, n
    )
    ke_phi = ke_c + phi_c

    # center -> wind-point averaging for PGF coefficient fields
    def to_u(f):  # [6, nz, N, N] -> [6, nz, N+1, N]
        return torch.cat(
            [f[:, :, :1], 0.5 * (f[:, :, 1:] + f[:, :, :-1]),
             f[:, :, -1:]], dim=2
        )

    def to_v(f):  # [6, nz, N, N] -> [6, nz, N, N+1]
        return torch.cat(
            [f[:, :, :, :1], 0.5 * (f[:, :, :, 1:] + f[:, :, :, :-1]),
             f[:, :, :, -1:]], dim=3
        )

    # theta at wind points for the cp*theta*grad(pi) term
    pt_at_u = to_u(pt_p)  # [6, nz, N+1, N]
    pt_at_v = to_v(pt_p)  # [6, nz, N, N+1]

    # --- dissipation on the BASE winds (once per substep) ----------------
    if d2_damp != 0.0:
        du_damp, dv_damp = div_damp(u, v, m, d2_damp)
        du_vd, dv_vd = vort_damp(u, v, m, VORT_DAMP_COEF)
        du_cd, dv_cd = corner_div_damp(u, v, m, CORNER_DAMP_COEF)
        du_damp = du_damp + du_vd + du_cd
        dv_damp = dv_damp + dv_vd + dv_cd
    else:
        du_damp = torch.zeros_like(u)
        dv_damp = torch.zeros_like(v)

    # --- wind updates -----------------------------------------------------
    dku = ke_phi[:, :, :, 1:] - ke_phi[:, :, :, :-1]
    dkv = ke_phi[:, :, 1:, :] - ke_phi[:, :, :-1, :]
    dpiu = pi_c[:, :, :, 1:] - pi_c[:, :, :, :-1]
    dpiv = pi_c[:, :, 1:, :] - pi_c[:, :, :-1, :]
    fyo_u = torch.nn.functional.pad(fyo, (0, 0, 0, 1))
    fxo_v = torch.nn.functional.pad(fxo, (0, 1))
    u_new_p = (
        fyo_u
        - (dt / m.dx_u[:, None]) * (dku + CP_AIR * pt_at_u * dpiu)
    )
    v_new_p = (
        -fxo_v
        - (dt / m.dy_v[:, None]) * (dkv + CP_AIR * pt_at_v * dpiv)
    )

    # perturbation-pressure gradient -(1/rho) grad_s(p') (the
    # nonhydrostatic part of the split PGF; nh_p_grad equivalent)
    pp_lay = 0.5 * (ppe[:, :-1] + ppe[:, 1:])
    alpha = -dz2 * GRAV / delp_new  # specific volume 1/rho
    pp_y = halo_exchange(pp_lay, h, fill="y")
    al_y = halo_exchange(alpha, h, fill="y")
    pp_c = _vertex_fix_scalar_corner(
        _corner_avg(pp_y), _vertex_cells(pp_y, h, n), h, n
    )
    u_new_p = u_new_p - (dt / m.dx_u[:, None]) * to_u(al_y) * (
        pp_c[:, :, :, 1:] - pp_c[:, :, :, :-1]
    )
    v_new_p = v_new_p - (dt / m.dy_v[:, None]) * to_v(al_y) * (
        pp_c[:, :, 1:, :] - pp_c[:, :, :-1, :]
    )

    u_new = u + u_new_p[:, :, h : h + n + 1, h : h + n] + du_damp
    v_new = v + v_new_p[:, :, h : h + n, h : h + n + 1] + dv_damp
    # re-impose single-valuedness of shared boundary D-edges
    u_new, v_new = average_dgrid_boundary(u_new, v_new)

    new = DycoreState(delp_new, pt_new, u_new, v_new, base.q, w2, dz2)
    return new, (fx, fy, crx, cry)


def remap_step(state: DycoreState, ak, bk, ptop, kord_tm=9, kord_mt=9,
               kord_tr=9, kord_wz=9):
    """Lagrangian -> Eulerian vertical remap to the ak/bk coordinate.

    Every field is remapped on its native [6, nz, Y, X] layout by
    ``ops.remap.remap_levels`` (the K5 kernel for CUDA tensors whose
    kord it covers); the tracers go as one [ntracer * 6, nz, n, n] stack.
    """
    delp, pt, u, v, q, w, delz = state
    pe1 = _interface_pressures(delp, ptop)  # source interface pressures
    ps = pe1[:, -1:]
    pe2 = ak.reshape(1, -1, 1, 1) + bk.reshape(1, -1, 1, 1) * ps
    rmp = remap_levels

    pt_new = rmp(pt, pe1, pe2, 1, kord_tm)
    delp_new = pe2[:, 1:] - pe2[:, :-1]

    # winds: average interface pressures to the staggered positions (the
    # edge-replicated extension makes 0.5*(p+p) reproduce the one-sided
    # form at face edges bit-for-bit)
    def stag_u(p):  # [6, nz+1, n, n] -> [6, nz+1, n+1, n]
        ext = extend_cells_one(p)
        return 0.5 * (ext[:, :, :-1, 1:-1] + ext[:, :, 1:, 1:-1])

    def stag_v(p):
        ext = extend_cells_one(p)
        return 0.5 * (ext[:, :, 1:-1, :-1] + ext[:, :, 1:-1, 1:])

    u_new = rmp(u, stag_u(pe1), stag_u(pe2), -1, kord_mt)
    v_new = rmp(v, stag_v(pe1), stag_v(pe2), -1, kord_mt)
    q_new = (
        rmp(q.flatten(0, 1), pe1, pe2, 0, kord_tr).reshape(q.shape)
        if q is not None else None
    )
    # w like a wind (kord_wz), delz via the specific volume -dz/dp
    # (mass-weighted, so total column height is conserved)
    w_new = rmp(w, pe1, pe2, -1, kord_wz)
    sv_new = rmp(-delz / delp, pe1, pe2, 1, kord_wz)
    delz_new = -sv_new * delp_new
    return DycoreState(
        delp_new, pt_new, u_new, v_new, q_new, w_new, delz_new
    )


def make_dycore_stepper(
    g: CubedSphereGrid,
    nz: int,
    dt_atmos: float,
    k_split: int = 1,
    n_split: int = 6,
    hord: int = 5,
    kord: int = 9,
    d2_damp: float = 0.12,
    ptop: float = 300.0,
    dtype=torch.float32,
    device=None,
):
    """Build the full dycore step (dynamics + vertical remap).

    Mirrors the reference namelist structure (k_split outer loops each
    ending in a remap, n_split substeps inside).  The metrics are built
    on the CPU and moved to `device` once: the CUDA device unless the
    caller passes another (``device="cpu"`` for the plain path).
    Returns (run, m, (ak, bk)) with run(state, phis, nsteps) -> state.
    """
    if device is None:
        device = default_device("make_dycore_stepper")
    m = SWMetrics.make(g, dtype, device=device)
    ak, bk = hybrid_coefficients(nz, ptop)
    ak = ak.to(dtype=dtype, device=device)
    bk = bk.to(dtype=dtype, device=device)
    one_dt = build_one_dt(
        m, ak, bk, nz, dt_atmos, k_split, n_split, hord, kord, d2_damp,
        ptop, dtype,
    )

    def run(state: DycoreState, phis, nsteps: int):
        for _ in range(nsteps):
            state = one_dt(state, phis)
        return state

    run.one_dt = one_dt
    return run, m, (ak, bk)


def build_one_dt(m, ak, bk, nz, dt_atmos, k_split, n_split, hord, kord,
                 d2_damp, ptop, dtype):
    """The full-dt step (k_split x [n_split substeps + tracer transport
    + remap]) as a function of (state, phis)."""
    dt_sub = dt_atmos / (k_split * n_split)
    h, n = m.halo, m.n
    N = n + 2 * h

    def one_dt(state: DycoreState, phis):
        for _ in range(k_split):
            st = state
            if st.q is not None:
                # flux accumulators feed ONLY the tracer transport
                zero = st.delp.new_zeros((st.delp.shape[0], nz, N, N))
                acc = (zero, zero, zero, zero)
            else:
                acc = (None,) * 4
            st2 = st
            for _ in range(n_split):
                st2, acc = dyn_substep(
                    st2, m, dt_sub, ptop, hord, d2_damp, phis, *acc
                )
            mfx, mfy, cxa, cya = acc
            # tracer transport with accumulated mass fluxes
            if st2.q is not None:
                apx = m.area_px[:, None] * halo_exchange(
                    st.delp, h, fill="x"
                )
                apy = m.area_py[:, None] * halo_exchange(
                    st.delp, h, fill="y"
                )

                def tr(qq):
                    qx = halo_exchange(qq, h, fill="x")
                    qy = halo_exchange(qq, h, fill="y")
                    fxq, fyq = fv_tp_2d(
                        qx, qy, cxa, cya, mfx, mfy, apx, apy, hord
                    )
                    dv = (fxq - _shx(fxq, 1)) + (fyq - _shy(fyq, 1))
                    return (
                        qq * st.delp
                        + dv[:, :, h : h + n, h : h + n] * m.rarea[:, None]
                    ) / st2.delp

                st2 = st2._replace(q=torch.stack([tr(qq) for qq in st2.q]))
            state = remap_step(st2, ak, bk, ptop, kord, kord, kord, kord)
        return state

    return one_dt
