"""GFS-style column physics suite in PyTorch (the JAX package's
``physics/gfs.py``).

The default suite of the coupled step:
  * surface exchange -- bulk aerodynamic fluxes with a Louis (1979)
    stability correction (GFS ``sfc_diff``/``sfc_ocean`` role);
  * PBL vertical diffusion -- bulk-Richardson boundary-layer height, a
    K-profile diffusivity and a backward-Euler implicit vertical solve
    per column (``moninedmf`` role);
  * Betts-Miller relaxed convection (SAS role), or the SAS-style mass
    flux of ``convection.py`` (``convection_scheme="mass_flux"``), and
    non-precipitating shallow convection (``gwd.shallow_convection``);
  * the orographic gravity-wave drag (``gwd.gravity_wave_drag``), on when
    ``h_std`` is passed;
  * Zhao-Carr microphysics: ``gscond`` condensation and ``precpd``
    precipitation with re-evaporation of falling rain; or the GFDL
    6-category scheme of ``gfdl_mp.py`` (``microphysics_scheme="gfdl"``),
    with the four hydrometeors prognostic when ``mp_tracers`` is passed.

Fields are [6, nz, n, n] (level 0 = top).  The JAX package's
``lax.scan`` recurrences over levels are Python loops over nz here, each
step one [6, n, n] tensor operation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from ..constants import (
    CP_AIR,
    GRAV,
    LATENT_HEAT_VAPORIZATION,
    RDGAS,
    RVGAS,
)

ZVIR = RVGAS / RDGAS - 1.0
KARMAN = 0.4
# the GFDL scheme's prognostic hydrometeors, in mp_tracers order
MP_TRACER_NAMES = (
    "cloud_ice_mixing_ratio",
    "rain_mixing_ratio",
    "snow_mixing_ratio",
    "graupel_mixing_ratio",
)
LV_CP = LATENT_HEAT_VAPORIZATION / CP_AIR
EPS = RDGAS / RVGAS


@dataclasses.dataclass(frozen=True)
class GFSPhysicsConfig:
    """Tunables of the suite (GFS namelist analogue)."""

    z0: float = 1.0e-4          # roughness length (m), ocean-like
    ri_crit: float = 0.25       # critical bulk Richardson number
    k_background: float = 0.1   # free-atmosphere diffusivity (m^2/s)
    k_max: float = 800.0        # diffusivity cap (m^2/s)
    tau_bm: float = 7200.0      # Betts-Miller relaxation time (s)
    convection_scheme: str = "betts_miller"  # or "mass_flux" (SAS-like)
    rh_bm: float = 0.8          # BM reference relative humidity
    tau_autoconv: float = 1800.0  # cloud->rain autoconversion time (s)
    evap_rain: float = 2.0e-5   # rain re-evaporation efficiency
    do_convection: bool = True
    do_shallow_convection: bool = True
    do_gwd: bool = True  # active only when h_std orography is passed
    do_pbl: bool = True
    do_surface: bool = True
    do_microphysics: bool = True
    # "zhao_carr" (gscond + precpd) or "gfdl" (the 6-category bulk
    # scheme of gfdl_mp.py)
    microphysics_scheme: str = "zhao_carr"


# --------------------------------------------------------------------------
# thermodynamic helpers
# --------------------------------------------------------------------------


def esat(t):
    """Bolton saturation vapor pressure over liquid (Pa)."""
    tc = t - 273.15
    return 611.2 * torch.exp(17.67 * tc / (tc + 243.5))


def qsat(t, p):
    es = torch.minimum(esat(t), 0.99 * p)
    return EPS * es / (p - (1.0 - EPS) * es)


def dqsat_dt(t, p):
    qs = qsat(t, p)
    return qs * 17.67 * 243.5 / (t - 273.15 + 243.5) ** 2


def _rev_cumsum(x):
    """Cumulative sum over levels from the bottom (axis 1)."""
    return torch.flip(torch.cumsum(torch.flip(x, dims=[1]), dim=1), dims=[1])


def _rev_cumprod(x):
    """Cumulative product over levels from the bottom of a bool tensor
    (torch's cumprod needs an integer dtype)."""
    x = torch.flip(x.to(torch.int32), dims=[1])
    return torch.flip(torch.cumprod(x, dim=1), dims=[1])


def pressure_fields(delp, ptop):
    """Interface and layer-mean pressures from delp [.., nz, ..]."""
    pe = ptop + torch.cat(
        [torch.zeros_like(delp[:, :1]), torch.cumsum(delp, dim=1)], dim=1
    )
    p = 0.5 * (pe[:, 1:] + pe[:, :-1])
    return pe, p


def layer_geometry(t, q, delp, pe):
    """Hydrostatic layer thickness dz and midpoint height above the
    surface (z=0 at the ground)."""
    tv = t * (1.0 + ZVIR * q)
    dlnp = torch.log(pe[:, 1:] / torch.clamp_min(pe[:, :-1], 1.0))
    dz = RDGAS * tv / GRAV * dlnp  # positive, top->bottom ordering
    below = _rev_cumsum(dz) - dz
    z_mid = below + 0.5 * dz
    return dz, z_mid


# --------------------------------------------------------------------------
# surface layer (sfc_diff / sfc_ocean role)
# --------------------------------------------------------------------------


def surface_exchange(t1, q1, u1, v1, p_sfc, p1, z1, tsfc, cfg):
    """Bulk exchange coefficients with Louis (1979) stability functions.
    Returns (cdm, cdh, ustar, qs_sfc, rib); cdm = cdh = C_d |U| (m/s)."""
    wind = torch.sqrt(u1 ** 2 + v1 ** 2 + 1.0e-3)
    th1 = t1 * (1.0e5 / p1) ** (RDGAS / CP_AIR)
    qs_sfc = qsat(tsfc, p_sfc)
    thv1 = th1 * (1.0 + ZVIR * q1)
    thvs = tsfc * (1.0e5 / p_sfc) ** (RDGAS / CP_AIR) * (
        1.0 + ZVIR * qs_sfc
    )
    rib = GRAV * z1 * (thv1 - thvs) / (thvs * wind ** 2)
    cn = (KARMAN / torch.log(z1 / cfg.z0)) ** 2
    b, c_, d = 5.0, 5.0, 5.0
    unstable = cn * (
        1.0
        - 2.0 * b * rib
        / (1.0 + 3.0 * b * c_ * cn * torch.sqrt(torch.abs(rib) * z1 / cfg.z0))
    )
    stable = cn / (1.0 + 2.0 * b * rib / torch.sqrt(1.0 + d * rib))
    cd = torch.where(rib < 0.0, unstable, stable)
    cd = torch.clamp_min(cd, 1.0e-5)
    cdm = cd * wind
    cdh = cd * wind  # equal heat/momentum transfer in this suite
    ustar = torch.sqrt(cd) * wind
    return cdm, cdh, ustar, qs_sfc, rib


# --------------------------------------------------------------------------
# PBL: K-profile + implicit vertical diffusion (moninedmf role)
# --------------------------------------------------------------------------


def tridiagonal_solve(a, b, c, d):
    """Batched Thomas algorithm along axis 1: tridiag(a, b, c) x = d with
    a the sub-diagonal (a[:, 0] ignored) and c the super-diagonal
    (c[:, -1] ignored).  Sequential in nz; each step is a [6, n, n] op."""
    nz = d.shape[1]
    cp = dp = torch.zeros_like(d[:, 0])
    cps, dps = [], []
    for k in range(nz):
        ak = a[:, k]
        denom = b[:, k] - ak * cp
        cp = c[:, k] / denom
        dp = (d[:, k] - ak * dp) / denom
        cps.append(cp)
        dps.append(dp)
    x = torch.zeros_like(d[:, 0])
    xs = [None] * nz
    for k in range(nz - 1, -1, -1):  # back substitution, bottom -> top
        x = dps[k] - cps[k] * x
        xs[k] = x
    return torch.stack(xs, dim=1)


def pbl_height(thv, z_mid, u, v, cfg):
    """Boundary-layer height: lowest level where the bulk Richardson
    number from the surface layer exceeds ri_crit."""
    thv1 = thv[:, -1:]
    du = u - u[:, -1:]
    dv = v - v[:, -1:]
    rib = (
        GRAV
        * (z_mid - z_mid[:, -1:])
        * (thv - thv1)
        / (thv1 * (du ** 2 + dv ** 2 + 0.1))
    )
    inside = rib < cfg.ri_crit  # True inside the PBL (from below)
    contig = _rev_cumprod(inside)
    h = torch.where(contig > 0, z_mid, 0.0).amax(dim=1)
    return torch.maximum(h, z_mid[:, -1])


def k_profile(z_if, h, ustar, cfg):
    """K-profile eddy diffusivity on interior interfaces (Troen-Mahrt
    shape kappa*u*z(1-z/h)^2)."""
    zr = torch.clip(z_if / h[:, None], 0.0, 1.0)
    k = KARMAN * ustar[:, None] * z_if * (1.0 - zr) ** 2
    return torch.clip(k, cfg.k_background, cfg.k_max)


def diffuse_column(x, mass, g_if, dt, sfc_g, x_sfc):
    """Implicit diffusion: mass_k (x'_k - x_k)/dt = F_{k-1} - F_k with
    F_k = g_if_k (x'_{k+1} - x'_k) between layers k and k+1, and surface
    flux F_sfc = sfc_g (x_sfc - x'_{nz-1}).  mass [kg/m^2] per layer;
    g_if, sfc_g [kg/m^2/s]."""
    gi = g_if * dt
    gs = sfc_g * dt
    if gs.ndim == x.ndim:
        gs = gs[:, 0]
    zeros = torch.zeros_like(x[:, :1])
    g_up = torch.cat([zeros, gi], dim=1)      # above layer k
    g_dn = torch.cat([gi, zeros], dim=1)      # below layer k
    a = -g_up
    c = -g_dn
    b = mass + g_up + g_dn
    d = mass * x
    # implicit surface exchange adds to the diagonal + rhs of layer nz-1
    b = torch.cat([b[:, :-1], (b[:, -1] + gs)[:, None]], dim=1)
    d = torch.cat([d[:, :-1], (d[:, -1] + gs * x_sfc)[:, None]], dim=1)
    return tridiagonal_solve(a, b, c, d)


# --------------------------------------------------------------------------
# Betts-Miller convection (SAS role)
# --------------------------------------------------------------------------


def moist_adiabat(t, q, p):
    """Lifted-parcel reference profile: lift the lowest-layer parcel
    (pseudo-adiabatically) through the column, bottom -> top.  Returns
    (t_ref, q_ref, active), active marking the contiguous buoyant region
    from the bottom."""
    nz = t.shape[1]
    tp, qp, p_prev = t[:, -1], q[:, -1], p[:, -1]
    t_par, q_par = [None] * nz, [None] * nz
    for k in range(nz - 1, -1, -1):
        pk = p[:, k]
        # dry adiabatic step then saturation adjustment
        t_dry = tp * (pk / p_prev) ** (RDGAS / CP_AIR)
        qs = qsat(t_dry, pk)
        gamma = LV_CP * dqsat_dt(t_dry, pk)
        cond = torch.clamp_min(qp - qs, 0.0) / (1.0 + gamma)
        tp = t_dry + LV_CP * cond
        qp = qp - cond
        p_prev = pk
        t_par[k], q_par[k] = tp, qp
    t_par = torch.stack(t_par, dim=1)
    q_par = torch.stack(q_par, dim=1)
    tv_par = t_par * (1.0 + ZVIR * q_par)
    tv_env = t * (1.0 + ZVIR * q)
    buoy = tv_par > tv_env
    active = _rev_cumprod(
        torch.cat([torch.ones_like(buoy[:, -1:]), buoy[:, :-1]], dim=1)
    ).bool()
    return t_par, q_par, active


def betts_miller(t, q, p, delp, dt, cfg):
    """Relaxed convective adjustment (Betts 1986; Frierson 2007
    simplified BM): relax T toward the lifted-parcel moist adiabat and q
    toward rh_bm * qsat(T_ref) over tau_bm, the T reference shifted so
    column enthalpy is conserved; precipitation is the column moisture
    removed.  Columns whose adjustment would give negative precipitation
    are left untouched."""
    t_ref, _, active = moist_adiabat(t, q, p)
    q_ref = cfg.rh_bm * qsat(t_ref, p)
    mass = delp / GRAV
    w = torch.where(active, mass, 0.0)
    wsum = torch.clamp_min(w.sum(dim=1, keepdim=True), 1.0e-10)
    dT0 = torch.where(active, t_ref - t, 0.0)
    dq0 = torch.where(active, q_ref - q, 0.0)
    shift = (w * (dT0 + LV_CP * dq0)).sum(dim=1, keepdim=True) / wsum
    dT = dT0 - shift * active
    dq = dq0
    f = dt / cfg.tau_bm
    precip = -(w * dq * f).sum(dim=1)  # kg/m^2 over dt
    do = (
        (precip > 0.0)[:, None] & active
        & (active.sum(dim=1, keepdim=True) > 1)
    )
    t_new = torch.where(do, t + f * dT, t)
    q_new = torch.where(do, q + f * dq, q)
    precip = torch.clamp_min(precip, 0.0) * do.any(dim=1).to(t.dtype)
    return t_new, q_new, precip


# --------------------------------------------------------------------------
# Zhao-Carr microphysics (gscond + precpd roles)
# --------------------------------------------------------------------------


def gscond(t, qv, qc, p, dt):
    """Grid-scale condensation/evaporation (Zhao & Carr 1997 gscond
    role), iterated twice with latent-heating feedback."""
    for _ in range(2):
        qs = qsat(t, p)
        gamma = LV_CP * dqsat_dt(t, p)
        excess = (qv - qs) / (1.0 + gamma)
        cond = torch.clamp_min(excess, 0.0)
        evap = torch.where(excess < 0.0, torch.minimum(qc, -excess), 0.0)
        qv = qv - cond + evap
        qc = qc + cond - evap
        t = t + LV_CP * (cond - evap)
    return t, qv, qc


def precpd(t, qv, qc, p, delp, dt, cfg):
    """Precipitation production + falling-rain re-evaporation (Zhao &
    Carr 1997 precpd role): rain forms by autoconversion, falls through
    the column within the step (top -> bottom) and partially
    re-evaporates in subsaturated layers.  precip is the flux leaving
    the bottom layer."""
    mass = delp / GRAV
    rain_src = qc * -math.expm1(-dt / cfg.tau_autoconv)
    qc = qc - rain_src
    nz = t.shape[1]
    flux = torch.zeros_like(t[:, 0])
    t_new, qv_new = [None] * nz, [None] * nz
    for k in range(nz):
        m_k, t_k, qv_k, p_k = mass[:, k], t[:, k], qv[:, k], p[:, k]
        flux = flux + rain_src[:, k] * m_k  # entering from above
        qs = qsat(t_k, p_k)
        subsat = torch.clamp_min(qs - qv_k, 0.0)
        gamma = LV_CP * dqsat_dt(t_k, p_k)
        evap = torch.minimum(
            cfg.evap_rain * dt * subsat / (1.0 + gamma) * torch.sqrt(
                torch.clamp_min(flux, 0.0) + 1.0e-12
            ),
            torch.minimum(flux / m_k, subsat / (1.0 + gamma)),
        )
        evap = torch.clamp_min(evap, 0.0)
        qv_new[k] = qv_k + evap
        t_new[k] = t_k - LV_CP * evap
        flux = flux - evap * m_k
    return (
        torch.stack(t_new, dim=1), torch.stack(qv_new, dim=1), qc, flux
    )


# --------------------------------------------------------------------------
# the full suite
# --------------------------------------------------------------------------


def _to_agrid(u_d, v_d):
    ua = 0.5 * (u_d[:, :, :-1, :] + u_d[:, :, 1:, :])
    va = 0.5 * (v_d[:, :, :, :-1] + v_d[:, :, :, 1:])
    return ua, va


def _tendency_to_dgrid(du_a, dv_a):
    pad_u = torch.cat(
        [du_a[:, :, :1], 0.5 * (du_a[:, :, 1:] + du_a[:, :, :-1]),
         du_a[:, :, -1:]], dim=2,
    )
    pad_v = torch.cat(
        [dv_a[:, :, :, :1], 0.5 * (dv_a[:, :, :, 1:] + dv_a[:, :, :, :-1]),
         dv_a[:, :, :, -1:]], dim=3,
    )
    return pad_u, pad_v


def gfs_physics_step(
    t, qv, qc, u_d, v_d, delp, tsfc, ptop, dt,
    cfg: GFSPhysicsConfig = GFSPhysicsConfig(),
    h_std=None,
    mp_tracers=None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One physics step.  Fields [6, nz, n, n] (winds D-grid staggered);
    tsfc [6, n, n]; h_std: optional subgrid-orography standard deviation
    [6, n, n] that turns on the gravity-wave drag.  mp_tracers: optional
    (qi, qr, qs, qg) prognostic hydrometeors for the GFDL scheme, which
    then takes qc as the cloud liquid and returns all six species.
    Returns (new_state, diagnostics)."""
    shape2d = t.shape[:1] + t.shape[2:]
    zeros2d = dict(dtype=t.dtype, device=t.device)

    pe, p = pressure_fields(delp, ptop)
    dz, z_mid = layer_geometry(t, qv, delp, pe)
    mass = delp / GRAV
    ua, va = _to_agrid(u_d, v_d)

    diags: Dict[str, torch.Tensor] = {}
    shf = torch.zeros(shape2d, **zeros2d)
    lhf = torch.zeros(shape2d, **zeros2d)
    h_pbl = torch.zeros(shape2d, **zeros2d)

    if cfg.do_surface or cfg.do_pbl:
        cdm, cdh, ustar, qs_sfc, _ = surface_exchange(
            t[:, -1], qv[:, -1], ua[:, -1], va[:, -1],
            pe[:, -1], p[:, -1], z_mid[:, -1], tsfc, cfg,
        )
        rho_sfc = pe[:, -1] / (RDGAS * t[:, -1] * (1 + ZVIR * qv[:, -1]))

    if cfg.do_pbl:
        th = t * (1.0e5 / p) ** (RDGAS / CP_AIR)
        thv = th * (1.0 + ZVIR * qv)
        h = pbl_height(thv, z_mid, ua, va, cfg)
        h_pbl = h
        z_if_int = z_mid[:, :-1] * 0.5 + z_mid[:, 1:] * 0.5
        k_if = k_profile(z_if_int, h, ustar, cfg)
        rho_if = 0.5 * (
            p[:, :-1] / (RDGAS * t[:, :-1])
            + p[:, 1:] / (RDGAS * t[:, 1:])
        )
        dz_if = 0.5 * (dz[:, :-1] + dz[:, 1:])
        g_if = rho_if * k_if / dz_if

        if cfg.do_surface:
            sfc_g_h = rho_sfc * cdh
            sfc_g_m = rho_sfc * cdm
        else:
            sfc_g_h = sfc_g_m = torch.zeros(shape2d, **zeros2d)

        # dry static energy (conserved under dry mixing)
        s = CP_AIR * t + GRAV * z_mid
        s_sfc = CP_AIR * tsfc
        zero_sfc = torch.zeros(shape2d, **zeros2d)
        s_new = diffuse_column(s, mass, g_if, dt, sfc_g_h, s_sfc)
        qv_new = diffuse_column(qv, mass, g_if, dt, sfc_g_h, qs_sfc)
        ua_new = diffuse_column(ua, mass, g_if, dt, sfc_g_m, zero_sfc)
        va_new = diffuse_column(va, mass, g_if, dt, sfc_g_m, zero_sfc)
        shf = sfc_g_h * (s_sfc - s_new[:, -1])
        lhf = (
            sfc_g_h * (qs_sfc - qv_new[:, -1])
            * LATENT_HEAT_VAPORIZATION
        )
        t = (s_new - GRAV * z_mid) / CP_AIR
        qv = qv_new
        du_d, dv_d = _tendency_to_dgrid(ua_new - ua, va_new - va)
        u_d = u_d + du_d
        v_d = v_d + dv_d

    precip_conv = torch.zeros(shape2d, **zeros2d)
    if cfg.do_convection:
        if cfg.convection_scheme == "mass_flux":
            from .convection import sas_mass_flux

            t, qv, precip_conv = sas_mass_flux(t, qv, p, pe, delp, dt)
        else:
            t, qv, precip_conv = betts_miller(t, qv, p, delp, dt, cfg)

    if cfg.do_shallow_convection:
        from .gwd import shallow_convection

        t, qv, sc_diags = shallow_convection(t, qv, p, delp, dt)
        diags.update(sc_diags)

    if cfg.do_gwd and h_std is not None:
        from .gwd import gravity_wave_drag

        ua2, va2 = _to_agrid(u_d, v_d)
        du_a, dv_a, gwd_diags = gravity_wave_drag(
            ua2, va2, t, p, delp, h_std, dt
        )
        du_d, dv_d = _tendency_to_dgrid(du_a, dv_a)
        u_d = u_d + du_d
        v_d = v_d + dv_d
        diags.update(gwd_diags)

    precip_ls = torch.zeros(shape2d, **zeros2d)
    mp_out = None
    if cfg.do_microphysics:
        if cfg.microphysics_scheme == "gfdl":
            from .gfdl_mp import gfdl_cloud_microphysics, liquid_fraction

            if mp_tracers is not None:
                # prognostic 6-species state: qc is cloud liquid, the
                # hydrometeors persist (and advect) between steps
                qi0, qr0, qs0, qg0 = mp_tracers
                ql0 = qc
            else:
                # 2-tracer form: partition the combined condensate by
                # temperature each step
                fl = liquid_fraction(t)
                ql0 = fl * qc
                qi0 = (1.0 - fl) * qc
                qr0 = qs0 = qg0 = torch.zeros_like(qc)
            mp_state, mp_diags = gfdl_cloud_microphysics(
                t, qv, ql0, qi0, qr0, qs0, qg0, p, delp, dz, dt,
            )
            t = mp_state["air_temperature"]
            qv = mp_state["specific_humidity"]
            if mp_tracers is not None:
                qc = mp_state["cloud_water_mixing_ratio"]
                mp_out = {k: mp_state[k] for k in MP_TRACER_NAMES}
            else:
                # fold all suspended condensate back into qc
                # (water-conserving)
                qc = (
                    mp_state["cloud_water_mixing_ratio"]
                    + mp_state["cloud_ice_mixing_ratio"]
                    + mp_state["rain_mixing_ratio"]
                    + mp_state["snow_mixing_ratio"]
                    + mp_state["graupel_mixing_ratio"]
                )
            diags.update({
                k: mp_diags[k]
                for k in ("rain_precipitation", "snow_precipitation",
                          "graupel_precipitation")
            })
            precip_ls = mp_diags["total_precipitation_mp"]
        else:
            t, qv, qc = gscond(t, qv, qc, p, dt)
            t, qv, qc, precip_ls = precpd(t, qv, qc, p, delp, dt, cfg)

    state = {
        "air_temperature": t,
        "specific_humidity": qv,
        "cloud_water_mixing_ratio": qc,
        "u_dgrid": u_d,
        "v_dgrid": v_d,
    }
    if mp_out is not None:
        state.update(mp_out)
    diags.update(
        sensible_heat_flux=shf,
        latent_heat_flux=lhf,
        planetary_boundary_layer_height=h_pbl,
        convective_precipitation=precip_conv,
        large_scale_precipitation=precip_ls,
        total_precipitation=precip_conv + precip_ls,
    )
    return state, diags
