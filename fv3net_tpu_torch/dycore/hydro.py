"""FV3-style dynamical core: Lagrangian layers + remap.

Counterpart of the JAX package's ``dycore/hydro.py``
(``make_dycore_stepper`` with the c_sw/d_sw substep, the hydrostatic
branch or the nonhydrostatic semi-implicit vertical solve, tracer
transport and the conservative vertical remap), face level, in PyTorch.
A state without w and delz steps hydrostatically, one with them
nonhydrostatically.  The shallow-water machinery of sw.py is applied per
Lagrangian layer with a theta-pi pressure-gradient force, n_split
acoustic-style substeps, accumulated mass fluxes for tracer transport,
and a conservative PPM vertical remap (ops.remap) back to the hybrid
ak/bk coordinate every k_split step.

Prognostic state (all [6, nz, ...] with D-grid staggering):
    delp  [6, nz, n, n]     layer pressure thickness (Pa)
    pt    [6, nz, n, n]     virtual potential temperature (K)
    u     [6, nz, n+1, n]   covariant x-wind on x-edges
    v     [6, nz, n, n+1]
    q     [ntracer, 6, nz, n, n]  tracer mixing ratios (optional)
    w     [6, nz, n, n]     vertical wind (m/s; nonhydrostatic only)
    delz  [6, nz, n, n]     layer thickness (m, < 0; nonhydrostatic only)

On CUDA tensors the hand-written kernels run: the transports
(ops/cuda_tp.py; the five nonhydrostatic D-stage transports as one fused
kernel when ``ops.advection.set_fused_transport(True)``), the vertical
solve (ops/cuda_sim1.py), the del-4 filters (ops/cuda_filter.py), the
nonhydrostatic column pressure chains (ops/cuda_column.py) and the
vertical remap (ops/cuda_remap.py).  The hydrostatic branch runs K1
(three transports a substep), K3 and K5: its substep core's pressure
chain keeps the interface Exner function, which K4 does not return, and
takes the plain form, as the JAX package's does.  In both branches the
C-grid half-stage runs as three fused kernels (ops/cuda_c_sw.py, K4's
column chain folded in) where its exchanges are the single-process
ones.  The substep has the JAX package's three schemes
(``dyn_substep``): the c_sw/d_sw default, the legacy two-stage midpoint
(c_half=False) and plain forward-backward (midpoint=False).  On CPU
tensors every piece runs its plain torch form.

FV3's routine clocks are device spans (``tracing.span``; nothing on
CPU tensors or in a mesh): ``dycore.dt`` around the dt; in each
c_sw/d_sw substep ``dycore.c_sw`` (the shared exchanges and the C-grid
half-stage) and ``dycore.d_sw`` (the substep core), inside which
``dycore.riem_solver`` (the column pressures, the vertical solve and
the dz exchange; nonhydrostatic) and ``dycore.damping`` (the three
dampers); then ``dycore.tracer_2d`` and ``dycore.remap``: 54 marks a
nonhydrostatic dt of 6 substeps.
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
from ..graphs import Graphed
from ..grid.geometry import CubedSphereGrid
from ..grid.halo import (
    average_dgrid_boundary,
    edge_pad,
    extend_cells_one,
    halo_exchange,
    halo_exchange_dgrid,
    spmd_active,
)
from ..ops.advection import (
    _fused5_enabled,
    fv_tp_2d,
    fv_tp_2d_multi5,
    ppm_flux,
    transports5,
)
from ..ops import cuda_c_sw
from ..ops.cuda_column import column_pressures, exner_chain
from ..ops.remap import remap_levels
from ..tracing import span
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
    vertex_masks,
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


def hybrid_coefficients(
    nz: int,
    ptop: float = 300.0,
    transition_eta: float = 0.2,
    exponent: float = 1.0,
    stretch: float = 1.4,
    table=None,
):
    """Hybrid sigma-p coefficients: pe = ak + bk * ps (float64 CPU tensors).

    Default: the Jablonowski & Williamson (2006) / DCMIP hybrid
    definition (the JAX package's): eta levels from eta_top = ptop/p0 to
    1 with a power-law `stretch` clustering resolution near the surface,
    bk = ((eta - eta_t)/(1 - eta_t))^exponent below the transition
    eta_t = `transition_eta` and 0 above it (FV3's `ks` pure-pressure
    top layers), ak = p0*(eta - bk).  ``table=(ak, bk)`` (e.g. read from
    a Fortran ``fv_core.res.nc`` restart) returns those exact values;
    each must have nz + 1 interfaces.
    """
    if table is not None:
        ak, bk = (np.asarray(c, np.float64) for c in table)
        if ak.shape != (nz + 1,) or bk.shape != (nz + 1,):
            raise ValueError(
                f"ak/bk table must have {nz + 1} interfaces, got "
                f"{ak.shape}/{bk.shape}"
            )
        return torch.as_tensor(ak), torch.as_tensor(bk)
    p0 = REFERENCE_SURFACE_PRESSURE
    eta_top = ptop / p0
    s = np.linspace(0.0, 1.0, nz + 1)
    eta = eta_top + (1.0 - eta_top) * s ** stretch
    # the base clipped at 0: the branch not taken raises no warning
    bk = np.where(
        eta > transition_eta,
        (np.maximum(eta - transition_eta, 0.0) / (1.0 - transition_eta))
        ** exponent,
        0.0,
    )
    bk[-1] = 1.0
    ak = p0 * (eta - bk)
    ak[-1] = 0.0
    # interfaces must stay monotone down to mountain-top surface pressures
    # (exponent > 1 transitions lose this below ~p0(1-1/c'))
    for ps in (45000.0, 101300.0):
        if not (np.diff(ak + bk * ps) > 0).all():
            raise ValueError(
                f"non-monotone hybrid coordinate for ps={ps}; lower "
                f"`exponent` or `transition_eta`"
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


def _vertex_fix_scalar_corner(arr_c, vals3, h, n, masks=(None,) * 4):
    """Replace cube-corner vertex entries of a corner-lattice array.

    masks: per-vertex applicability (sw.vertex_masks) -- under
    within-face tiling only tiles touching the cube vertex apply the
    fix; None means always (face level)."""
    hn = h + n
    for (cj, ci), v3, vm in zip(
        ((h, h), (h, hn), (hn, h), (hn, hn)), vals3, masks
    ):
        arr_c = _masked_vertex_set(arr_c, (cj, ci), v3, vm)
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

    Face-level CUDA tensors outside a mesh take the fused kernels
    (ops/cuda_c_sw.py, ``_c_sw_fused``); everything else
    ``_c_sw_half_chain``, the kernels' plain version.
    """
    if _c_sw_fused(state.delp, m):
        return cuda_c_sw.c_sw_half_cuda(m, dt2, ptop, phis, up, vp, dpx,
                                        dpy, ptx, pty)
    return _c_sw_half_chain(state, m, dt2, ptop, phis, up, vp, dpx, dpy,
                            ptx, pty)


def _c_sw_fused(x: torch.Tensor, m: SWMetrics) -> bool:
    """Whether the C half-stage of `x`'s step takes the fused kernels: a
    CUDA tensor, the single-process exchanges whose tables the kernels
    read (no ``grid.halo.spmd_mode``) and metrics of whole faces."""
    return x.is_cuda and not spmd_active() and m.edge_w is None


def _c_sw_half_chain(state: DycoreState, m: SWMetrics, dt2: float,
                     ptop: float, phis, up, vp, dpx, dpy, ptx, pty):
    """``_c_sw_half_3d`` as a chain of torch operations: its form on the
    CPU, on the meshes and on tiles, and the fused kernels' plain
    version."""
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

    # Exner + hydrostatic geopotential of the half-updated columns (K4 on
    # CUDA, in both the hydrostatic and the nonhydrostatic step).  The
    # unused halo-corner columns of the padded delpc may hold garbage:
    # the kernel branch (CUDA) guards the Exner power with pe >= 1e-30,
    # the plain branch does not -- both exactly as the JAX package's
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


def _exchanges(state: DycoreState, h: int):
    """(up, vp, dpx, dpy, ptx, pty): the D-grid wind exchange and the
    x- and y-fill exchanges of delp and pt that a substep's stages
    share."""
    up, vp = halo_exchange_dgrid(state.u, state.v, h)
    return (up, vp, halo_exchange(state.delp, h, fill="x"),
            halo_exchange(state.delp, h, fill="y"),
            halo_exchange(state.pt, h, fill="x"),
            halo_exchange(state.pt, h, fill="y"))


def dyn_substep(state: DycoreState, m: SWMetrics, dt: float, ptop: float,
                hord: int, d2_damp: float, phis,
                mfx_acc, mfy_acc, cx_acc, cy_acc,
                midpoint: bool = True, c_half: bool = True):
    """One acoustic-style substep on the Lagrangian layers.

    midpoint=True: time-centered advective winds.  c_half=True (the
    default) uses the cheap C-grid half-stage (``_c_sw_half_3d``,
    FV3's c_sw role): only the advecting C winds are half-stepped and
    the D stage runs once from the time-n state.  c_half=False keeps
    the legacy two-stage midpoint scheme (a full provisional D-grid
    half step with 1st-order reconstruction and no dissipation);
    midpoint=False is plain forward-backward (weakly unstable for
    rotational modes, see sw.shallow_water_step).

    Returns (new_state_without_tracers, accumulated fluxes).
    """
    if midpoint and c_half:
        with span("dycore.c_sw", state.delp):
            exch = _exchanges(state, m.halo)
            adv = _c_sw_half_3d(state, m, 0.5 * dt, ptop, phis, *exch)
        with span("dycore.d_sw", state.delp):
            new, (fx, fy, crx, cry) = _substep_core(
                state, state, m, dt, ptop, hord, d2_damp, phis,
                exch=exch, adv=adv,
            )
    elif midpoint:
        # nondimensional damping applied once per substep (stage 2)
        half, _ = _substep_core(state, state, m, 0.5 * dt, ptop, 1,
                                0.0, phis)
        new, (fx, fy, crx, cry) = _substep_core(
            half, state, m, dt, ptop, hord, d2_damp, phis
        )
    else:
        new, (fx, fy, crx, cry) = _substep_core(
            state, state, m, dt, ptop, hord, d2_damp, phis
        )
    if mfx_acc is None:  # tracer-free run: no accumulation carried
        return new, (None, None, None, None)
    return new, (mfx_acc + fx, mfy_acc + fy, cx_acc + crx, cy_acc + cry)


def _substep_core(ev: DycoreState, base: DycoreState, m: SWMetrics,
                  dt: float, ptop: float, hord: int, d2_damp: float,
                  phis, exch=None, adv=None):
    """Flux-form update of `base` (the D stage) with fluxes and gradients
    evaluated on `ev` (midpoint stage form; ev is base for
    forward-backward; under the c_sw scheme ev IS base and `adv` carries
    the time-centered advective C winds from the half-stage).

    exch: optional precomputed (up, vp, dpx, dpy, ptx, pty) halo
    exchanges of ev's fields (shared with the C half-stage).  adv:
    optional (uc, vc) padded advective winds; without them the C winds
    come from ev's D winds.

    Hydrostatic when ev.w is None: delp, pt and the vorticity are
    transported and the geopotential integrates cp*theta*d(pi) upward.
    Otherwise nonhydrostatic: w is transported mass-weighted and delz
    volume-weighted alongside the other prognostics, the semi-implicit
    Riemann solver (riemann.py) advances the vertical acoustics, the
    geopotential in the wind update comes from the TRUE layer heights
    (delz), and the winds get the perturbation-pressure gradient
    -(1/rho) grad_s(p') on top of the hydrostatic cp*theta*grad(pi) term.
    """
    nonhydro = ev.w is not None
    h, n = m.halo, m.n
    u, v = ev.u, ev.v
    up, vp, dpx, dpy, ptx, pty = (
        exch if exch is not None else _exchanges(ev, h)
    )
    if adv is not None:
        uc, vc = adv
    else:
        # C-face contravariant winds, canonical (see sw.c_grid_winds)
        uc, vc = padded_cgrid_winds(u, v, m, up, vp)[:2]

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

    if nonhydro:
        # the five transports (ops.advection.transports5): fused into one
        # call when the switch is on (the JAX package's fused branch,
        # without its 128-lane gate), else five fv_tp_2d calls
        wx = halo_exchange(ev.w, h, fill="x")
        wy = halo_exchange(ev.w, h, fill="y")
        dzx = halo_exchange(ev.delz, h, fill="x")
        dzy = halo_exchange(ev.delz, h, fill="y")
        args = (dpx, dpy, ptx, pty, wx, wy, dzx, dzy, omega_x, omega_y, crx,
                cry, xfx, yfx, sfx, sfy, m.area_px, m.area_py, hord)
        (fx, fy, fxt, fyt, fxw, fyw, fxz, fyz, fxo, fyo) = (
            fv_tp_2d_multi5(*args) if _fused5_enabled()
            else transports5(fv_tp_2d, *args)
        )
    else:
        # the three transports of the hydrostatic branch (the JAX
        # package's hydro.py:423-438; it never fuses them): delp with the
        # area fluxes, pt mass-weighted with the delp fluxes, vorticity
        apx, apy = m.area_px[:, None], m.area_py[:, None]
        fx, fy = fv_tp_2d(dpx, dpy, crx, cry, xfx, yfx, apx, apy, hord)
        fxt, fyt = fv_tp_2d(ptx, pty, crx, cry, fx, fy, apx * dpx,
                            apy * dpy, hord)
        fxo, fyo = fv_tp_2d(omega_x, omega_y, crx, cry, sfx, sfy, apx, apy,
                            hord)

    def flux_div(fx_, fy_):
        d = (fx_ - _shx(fx_, 1)) + (fy_ - _shy(fy_, 1))
        return d[:, :, h : h + n, h : h + n] * m.rarea[:, None]

    fc = FILTER_COEF if d2_damp != 0.0 else 0.0
    delp_new = scalar_filter(base.delp + flux_div(fx, fy), m, fc)
    pt_new = scalar_filter(
        base.pt * base.delp + flux_div(fxt, fyt), m, fc
    ) / delp_new
    if nonhydro:
        # w: mass-weighted (like pt); delz: volume-form with the area
        # fluxes (conserves total volume)
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
    vmasks = vertex_masks(m)
    for ((cj, ci), es), vm in zip(vert_edges, vmasks):
        a, b, c = (arr[:, :, j, i] for arr, j, i in es)
        ke_c = _masked_vertex_set(
            ke_c, (cj, ci), (a * a + b * b + c * c) / 3.0, vm
        )

    # hydrostatic pressure and Exner function on the NEW mass field
    # (forward-backward coupling), all on fill='y' padded fields
    dp_p = halo_exchange(delp_new, h, fill="y")
    pt_p = halo_exchange(pt_new, h, fill="y")
    phis_p = (
        halo_exchange(phis, h, fill="y")[:, None]
        if phis is not None
        else 0.0
    )
    if nonhydro:
        with span("dycore.riem_solver", dp_p):
            pe_p, pi_lay, pm_p = column_pressures(dp_p, ptop)
            # vertical acoustics: semi-implicit solve on the transported
            # state (Riem_Solver3 position in fv_dynamics), then the TRUE
            # geopotential from the solved layer heights
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
            else:
                ws_full = torch.zeros_like(dp_p[:, 0])
            # pe, pm and ws padded: the solve reads their interior (no
            # copy)
            w2, dz2, ppe = sim1_solve(
                dt, dm_int, pt_new, dz_adv, w_adv, pe_p, pm_p, ws_full,
                halo=h,
            )
            dz_p = halo_exchange(dz2, h, fill="y")
        dphi = -GRAV * dz_p  # positive downward
    else:
        # hydrostatic: the plain chain keeps the interface Exner function
        # pik (K4 does not return it); integrate cp*theta*d(pi)
        _, pik, pi_lay = exner_chain(dp_p, ptop)
        dphi = CP_AIR * pt_p * (pik[:, 1:] - pik[:, :-1])
    phi_lay = _geopotential(dphi, phis_p)

    phi_c = _vertex_fix_scalar_corner(
        _corner_avg(phi_lay), _vertex_cells(phi_lay, h, n), h, n, vmasks
    )
    pi_c = _vertex_fix_scalar_corner(
        _corner_avg(pi_lay), _vertex_cells(pi_lay, h, n), h, n, vmasks
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
        with span("dycore.damping", base.u):
            du_damp, dv_damp = div_damp(base.u, base.v, m, d2_damp)
            du_vd, dv_vd = vort_damp(base.u, base.v, m, VORT_DAMP_COEF)
            du_cd, dv_cd = corner_div_damp(
                base.u, base.v, m, CORNER_DAMP_COEF
            )
            du_damp = du_damp + du_vd + du_cd
            dv_damp = dv_damp + dv_vd + dv_cd
    else:
        du_damp = torch.zeros_like(base.u)
        dv_damp = torch.zeros_like(base.v)

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

    if nonhydro:
        # perturbation-pressure gradient -(1/rho) grad_s(p') (the
        # nonhydrostatic part of the split PGF; nh_p_grad equivalent)
        pp_lay = 0.5 * (ppe[:, :-1] + ppe[:, 1:])
        alpha = -dz2 * GRAV / delp_new  # specific volume 1/rho
        pp_y = halo_exchange(pp_lay, h, fill="y")
        al_y = halo_exchange(alpha, h, fill="y")
        pp_c = _vertex_fix_scalar_corner(
            _corner_avg(pp_y), _vertex_cells(pp_y, h, n), h, n, vmasks
        )
        u_new_p = u_new_p - (dt / m.dx_u[:, None]) * to_u(al_y) * (
            pp_c[:, :, :, 1:] - pp_c[:, :, :, :-1]
        )
        v_new_p = v_new_p - (dt / m.dy_v[:, None]) * to_v(al_y) * (
            pp_c[:, :, 1:, :] - pp_c[:, :, :-1, :]
        )

    u_new = base.u + u_new_p[:, :, h : h + n + 1, h : h + n] + du_damp
    v_new = base.v + v_new_p[:, :, h : h + n, h : h + n + 1] + dv_damp
    # re-impose single-valuedness of shared boundary D-edges
    u_new, v_new = average_dgrid_boundary(u_new, v_new)

    new = DycoreState(
        delp_new, pt_new, u_new, v_new, base.q,
        w2 if nonhydro else None, dz2 if nonhydro else None,
    )
    return new, (fx, fy, crx, cry)


def remap_step(state: DycoreState, ak, bk, ptop, kord_tm=9, kord_mt=9,
               kord_tr=9, kord_wz=9):
    """Lagrangian -> Eulerian vertical remap to the ak/bk coordinate.

    Every field is remapped on its native [6, nz, Y, X] layout by
    ``ops.remap.remap_levels`` (the K5 kernel for CUDA tensors whose
    kord it covers); the tracers go as one [ntracer * 6, nz, n, n] stack;
    w and delz only where the state carries them.
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
    if w is not None:
        # w like a wind (kord_wz), delz via the specific volume -dz/dp
        # (mass-weighted, so total column height is conserved)
        w_new = rmp(w, pe1, pe2, -1, kord_wz)
        sv_new = rmp(-delz / delp, pe1, pe2, 1, kord_wz)
        delz_new = -sv_new * delp_new
    else:
        w_new, delz_new = None, None
    return DycoreState(
        delp_new, pt_new, u_new, v_new, q_new, w_new, delz_new
    )


def capture_key():
    """What a dt reads at capture time besides its arguments: the
    fused-transport switch (``ops.advection.set_fused_transport``).  A
    graph of a step that composes the dt joins it to its cache key."""
    return (_fused5_enabled(),)


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
    remat: bool = False,
    metric_cwinds: bool = True,
    metric_ke: bool = True,
    corner_damp: bool = True,
    donate: bool = False,
    c_half: bool = True,
    device=None,
):
    """Build the full dycore step (dynamics + vertical remap).

    Mirrors the reference namelist structure (k_split outer loops each
    ending in a remap, n_split substeps inside).  The metrics are built
    on the CPU and moved to `device` once: the CUDA device unless the
    caller passes another (``device="cpu"`` for the plain path).
    metric_cwinds, metric_ke, corner_damp: SWMetrics.make's scheme
    switches; c_half=False: the legacy two-stage midpoint substep
    (dyn_substep).  remat: checkpoint each acoustic substep (its
    activations recomputed in the backward pass, ``build_one_dt``),
    trading recompute for memory in a differentiated step; a forward
    step is unchanged.

    Returns (run, m, (ak, bk)) with run(state, phis, nsteps) -> state.
    On CUDA tensors ``run`` replays a CUDA graph of one dt nsteps times
    (``graphs.Graphed``; the counterpart of the JAX package's jitted
    scan), captured on the first call for each set of shapes and fused
    transport switch; on the CPU it is the eager loop.  donate=True: the
    input state is consumed and the result returned in its buffers (no
    state copy at the call boundary; valid until the next call); else
    the input is left untouched and the result is fresh tensors.
    ``run.one_dt`` is the eager one-dt body, which the coupled step
    composes and autograd differentiates.
    """
    if device is None:
        device = default_device("make_dycore_stepper")
    m = SWMetrics.make(
        g, dtype, metric_cwinds=metric_cwinds, metric_ke=metric_ke,
        corner_damp=corner_damp, device=device,
    )
    ak, bk = hybrid_coefficients(nz, ptop)
    ak = ak.to(dtype=dtype, device=device)
    bk = bk.to(dtype=dtype, device=device)
    one_dt = build_one_dt(
        m, ak, bk, nz, dt_atmos, k_split, n_split, hord, kord, d2_damp,
        ptop, dtype, remat, c_half=c_half,
    )
    graphed = Graphed(one_dt, carry="all", donate=donate, key=capture_key)

    def run(state: DycoreState, phis, nsteps: int):
        if state.delp.device.type == "cuda":
            return graphed(state, phis, steps=nsteps)
        for _ in range(nsteps):
            state = one_dt(state, phis)
        return state

    run.one_dt = one_dt
    run.graphed = graphed
    return run, m, (ak, bk)


class _Remat(torch.autograd.Function):
    """fn(*xs) -> tuple of tensors (or None), its activations not kept:
    the forward runs without a graph, and the backward recomputes it and
    takes the vector-Jacobian product of the recomputed graph.  The
    checkpoint of ``build_one_dt(remat=True)``.  Neither form of
    ``torch.utils.checkpoint`` serves here: the non-reentrant one
    installs saved-tensor hooks, which the dampers' ``torch.func.vjp``
    refuses, and the reentrant one cannot be differentiated by
    ``torch.autograd.grad``."""

    @staticmethod
    def forward(ctx, fn, *xs):
        ctx.fn = fn
        ctx.save_for_backward(*xs)
        with torch.no_grad():
            return fn(*xs)

    @staticmethod
    def backward(ctx, *grads):
        xs = [
            None if x is None else x.detach().requires_grad_(x.requires_grad)
            for x in ctx.saved_tensors
        ]
        with torch.enable_grad():
            out = ctx.fn(*xs)
        pairs = [(o, g) for o, g in zip(out, grads)
                 if o is not None and g is not None and o.requires_grad]
        wrt = [x for x in xs if x is not None and x.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True,
        ) if pairs and wrt else [None] * len(wrt))
        return (None, *(
            next(got) if x is not None and x.requires_grad else None
            for x in xs
        ))


def build_one_dt(m, ak, bk, nz, dt_atmos, k_split, n_split, hord, kord,
                 d2_damp, ptop, dtype, remat=False, c_half=True):
    """The full-dt step (k_split x [n_split substeps + tracer transport
    + remap]) as a function of (state, phis).  remat: each acoustic
    substep checkpointed (``_Remat``) where the JAX package puts
    ``jax.checkpoint``: in a differentiated step its activations are
    recomputed in the backward pass instead of kept; a forward step is
    unchanged."""
    dt_sub = dt_atmos / (k_split * n_split)
    h, n = m.halo, m.n
    N = n + 2 * h

    def substep(st, acc, phis):
        return dyn_substep(
            st, m, dt_sub, ptop, hord, d2_damp, phis, *acc, c_half=c_half,
        )

    def substep_remat(st, acc, phis):
        ns = len(st)

        def flat(*xs):
            s2, a2 = substep(type(st)(*xs[:ns]), xs[ns:-1], xs[-1])
            return (*s2, *a2)

        out = _Remat.apply(flat, *st, *acc, phis)
        return type(st)(*out[:ns]), tuple(out[ns:])

    def one_dt(state: DycoreState, phis):
        with span("dycore.dt", state.delp):
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
                    st2, acc = (substep_remat if remat else substep)(
                        st2, acc, phis)
                mfx, mfy, cxa, cya = acc
                # tracer transport with accumulated mass fluxes
                if st2.q is not None:
                    with span("dycore.tracer_2d", st2.delp):
                        st2 = st2._replace(
                            q=tracer_2d(st, st2, mfx, mfy, cxa, cya))
                with span("dycore.remap", st2.delp):
                    state = remap_step(st2, ak, bk, ptop, kord, kord, kord,
                                       kord)
        return state

    def tracer_2d(st, st2, mfx, mfy, cxa, cya):
        apx = m.area_px[:, None] * halo_exchange(st.delp, h, fill="x")
        apy = m.area_py[:, None] * halo_exchange(st.delp, h, fill="y")

        def tr(qq):
            qx = halo_exchange(qq, h, fill="x")
            qy = halo_exchange(qq, h, fill="y")
            fxq, fyq = fv_tp_2d(qx, qy, cxa, cya, mfx, mfy, apx, apy, hord)
            dv = (fxq - _shx(fxq, 1)) + (fyq - _shy(fyq, 1))
            return (
                qq * st.delp
                + dv[:, :, h : h + n, h : h + n] * m.rarea[:, None]
            ) / st2.delp

        return torch.stack([tr(qq) for qq in st2.q])

    return one_dt
