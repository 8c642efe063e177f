"""The GFS-style column physics of the coupled C48 configuration, plain
torch.

A frozen copy of the plain forms of the port's physics on the
configuration's path (``fv3net_tpu_torch/physics/``): the surface
exchange and the K-profile PBL of ``gfs.py``, the SAS-style mass-flux
deep convection of ``convection.py``, the shallow convection of
``gwd.py``, the GFDL 6-category microphysics of ``gfdl_mp.py`` with its
four hydrometeors prognostic, and gray radiation's ``_core`` of
``radiation.py``.  Fields are [6, nz, n, n] with level 0 at the top;
each recurrence over levels is a Python loop over nz, each step one
[6, n, n] operation, as in the port.

Departures from the port:

* only the configuration's branches are here: Betts-Miller, Zhao-Carr,
  the GFDL scheme's two-tracer form and the orographic drag (off where
  no ``h_std`` is passed) are left out, and the tunables are the
  port's defaults, written as module constants;
* the ``graphs.jit`` capture of ``gfs_physics_step`` and the device
  spans of ``tracing`` are left out;
* ``sas_mass_flux`` also returns where it fired and
  ``gfs_physics_step`` passes that on (``sas_fired``), for the cell's
  report of where convection ran.

The SAS scheme returns a precipitation rate (kg m^-2 s^-1) that the
suite adds to the microphysics' amount over the step (kg m^-2), as the
port and the JAX package do; the copy keeps it.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .constants import (
    CP_AIR,
    GRAV,
    LATENT_HEAT_FUSION,
    LATENT_HEAT_VAPORIZATION,
    RDGAS,
    RVGAS,
)

LV = LATENT_HEAT_VAPORIZATION
LF = LATENT_HEAT_FUSION
LS = LV + LF
LV_CP = LV / CP_AIR
EPS = RDGAS / RVGAS
ZVIR = RVGAS / RDGAS - 1.0
KARMAN = 0.4

# the suite's tunables (the port's GFSPhysicsConfig defaults)
Z0 = 1.0e-4            # roughness length (m)
RI_CRIT = 0.25         # critical bulk Richardson number
K_BACKGROUND = 0.1     # free-atmosphere diffusivity (m^2/s)
K_MAX = 800.0          # diffusivity cap (m^2/s)

# SAS (the port's SASConfig defaults)
ENTRAINMENT = 1.0e-4   # fractional entrainment (1/m)
TAU_SAS = 3600.0       # CAPE relaxation time (s)
CAPE_TRIGGER = 100.0   # J/kg
MAX_COURANT = 0.4

# shallow convection (gwd.shallow_convection's defaults)
SHALLOW_DEPTH_PA = 2.5e4
SHALLOW_TAU = 3600.0
SHALLOW_CAPE_MIN = 0.0

# GFDL microphysics (the port's GFDLMPConfig defaults)
T_FREEZE = 273.16
T_ICE_ALL = 233.16
QL0_AUTO = 5.0e-4
QI0_AUTO = 1.0e-4
TAU_L2R = 900.0
TAU_I2S = 1800.0
C_ACC_RAIN = 3.0e-3
C_ACC_SNOW = 1.0e-3
TAU_MELT = 900.0
TAU_FRZ = 900.0
TAU_REVAP = 1800.0
V_RAIN = 6.0
V_SNOW = 1.0
V_GRAUPEL = 4.0
SAT_ADJ_ITERS = 2

# gray radiation (the port's RadiationDriver defaults)
SW_TAU0 = 0.2
LW_TAU0 = 4.0
ALBEDO = 0.12
SOLAR_CONSTANT = 1361.0  # W/m^2
STEFAN_BOLTZMANN = 5.670374e-8

MP_TRACER_NAMES = (
    "cloud_ice_mixing_ratio",
    "rain_mixing_ratio",
    "snow_mixing_ratio",
    "graupel_mixing_ratio",
)


# --- thermodynamic helpers (gfs.py) ----------------------------------------

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
    """Cumulative product over levels from the bottom of a bool tensor."""
    x = torch.flip(x.to(torch.int32), dims=[1])
    return torch.flip(torch.cumprod(x, dim=1), dims=[1])


def pressure_fields(delp, ptop):
    """Interface and layer-mean pressures from delp."""
    pe = ptop + torch.cat(
        [torch.zeros_like(delp[:, :1]), torch.cumsum(delp, dim=1)], dim=1
    )
    p = 0.5 * (pe[:, 1:] + pe[:, :-1])
    return pe, p


def layer_geometry(t, q, delp, pe):
    """Hydrostatic layer thickness dz and midpoint height above the
    surface."""
    tv = t * (1.0 + ZVIR * q)
    dlnp = torch.log(pe[:, 1:] / torch.clamp_min(pe[:, :-1], 1.0))
    dz = RDGAS * tv / GRAV * dlnp
    below = _rev_cumsum(dz) - dz
    z_mid = below + 0.5 * dz
    return dz, z_mid


# --- surface layer and PBL (gfs.py) ------------------------------------------

def surface_exchange(t1, q1, u1, v1, p_sfc, p1, z1, tsfc):
    """Bulk exchange coefficients with Louis (1979) stability functions:
    (cdm, cdh, ustar, qs_sfc, rib)."""
    wind = torch.sqrt(u1 ** 2 + v1 ** 2 + 1.0e-3)
    th1 = t1 * (1.0e5 / p1) ** (RDGAS / CP_AIR)
    qs_sfc = qsat(tsfc, p_sfc)
    thv1 = th1 * (1.0 + ZVIR * q1)
    thvs = tsfc * (1.0e5 / p_sfc) ** (RDGAS / CP_AIR) * (
        1.0 + ZVIR * qs_sfc
    )
    rib = GRAV * z1 * (thv1 - thvs) / (thvs * wind ** 2)
    cn = (KARMAN / torch.log(z1 / Z0)) ** 2
    b, c_, d = 5.0, 5.0, 5.0
    unstable = cn * (
        1.0
        - 2.0 * b * rib
        / (1.0 + 3.0 * b * c_ * cn * torch.sqrt(torch.abs(rib) * z1 / Z0))
    )
    stable = cn / (1.0 + 2.0 * b * rib / torch.sqrt(1.0 + d * rib))
    cd = torch.where(rib < 0.0, unstable, stable)
    cd = torch.clamp_min(cd, 1.0e-5)
    cdm = cd * wind
    cdh = cd * wind
    ustar = torch.sqrt(cd) * wind
    return cdm, cdh, ustar, qs_sfc, rib


def tridiagonal_solve(a, b, c, d):
    """Batched Thomas algorithm along axis 1 (a[:, 0] and c[:, -1]
    ignored)."""
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
    for k in range(nz - 1, -1, -1):
        x = dps[k] - cps[k] * x
        xs[k] = x
    return torch.stack(xs, dim=1)


def pbl_height(thv, z_mid, u, v):
    """Lowest level where the bulk Richardson number from the surface
    layer exceeds RI_CRIT."""
    thv1 = thv[:, -1:]
    du = u - u[:, -1:]
    dv = v - v[:, -1:]
    rib = (
        GRAV
        * (z_mid - z_mid[:, -1:])
        * (thv - thv1)
        / (thv1 * (du ** 2 + dv ** 2 + 0.1))
    )
    inside = rib < RI_CRIT
    contig = _rev_cumprod(inside)
    h = torch.where(contig > 0, z_mid, 0.0).amax(dim=1)
    return torch.maximum(h, z_mid[:, -1])


def k_profile(z_if, h, ustar):
    """K-profile eddy diffusivity on the interior interfaces."""
    zr = torch.clip(z_if / h[:, None], 0.0, 1.0)
    k = KARMAN * ustar[:, None] * z_if * (1.0 - zr) ** 2
    return torch.clip(k, K_BACKGROUND, K_MAX)


def diffuse_column(x, mass, g_if, dt, sfc_g, x_sfc):
    """Implicit diffusion with an implicit surface flux into the lowest
    layer."""
    gi = g_if * dt
    gs = sfc_g * dt
    if gs.ndim == x.ndim:
        gs = gs[:, 0]
    zeros = torch.zeros_like(x[:, :1])
    g_up = torch.cat([zeros, gi], dim=1)
    g_dn = torch.cat([gi, zeros], dim=1)
    a = -g_up
    c = -g_dn
    b = mass + g_up + g_dn
    d = mass * x
    b = torch.cat([b[:, :-1], (b[:, -1] + gs)[:, None]], dim=1)
    d = torch.cat([d[:, :-1], (d[:, -1] + gs * x_sfc)[:, None]], dim=1)
    return tridiagonal_solve(a, b, c, d)


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


# --- SAS mass-flux deep convection (convection.py) --------------------------

def _mse(t, qv, z):
    return CP_AIR * t + GRAV * z + LV * qv


def _heights(t, qv, delp, pe):
    tv = t * (1.0 + 0.608 * qv)
    dz = RDGAS * tv * delp / (GRAV * 0.5 * (pe[:, 1:] + pe[:, :-1]))
    below = torch.flip(
        torch.cumsum(torch.flip(dz, dims=[1]), dim=1), dims=[1]
    ) - dz
    return below + 0.5 * dz


def _at_level(x, k):
    """x [6, nz, n, n] at the per-column level k [6, n, n]."""
    return torch.gather(x, 1, k[:, None])[:, 0]


def sas_mass_flux(t, qv, p, pe, delp, dt: float):
    """One deep-convection step: (t_new, qv_new, precip_rate
    [kg/m^2/s], fire [6, n, n] bool)."""
    nz = t.shape[1]
    dev = t.device
    z = _heights(t, qv, delp, pe)
    h_env = _mse(t, qv, z)
    hsat_env = CP_AIR * t + GRAV * z + LV * qsat(t, p)

    kb0 = 3 * nz // 4
    karr = torch.arange(nz, device=dev)[None, :, None, None]
    h_low = torch.where(karr >= kb0, h_env, -torch.inf)
    kb = torch.argmax(h_low, dim=1)
    h_base = h_low.amax(dim=1)
    q_base = _at_level(qv, kb)

    tv = t * (1.0 + 0.608 * qv)
    dz = RDGAS * tv * delp / (GRAV * 0.5 * (pe[:, 1:] + pe[:, :-1]))

    h_u = torch.full_like(h_base, -torch.inf)
    started = torch.zeros(h_base.shape, dtype=torch.bool, device=dev)
    h_us, buoys = [None] * nz, [None] * nz
    for k in range(nz - 1, -1, -1):
        h_e, hs_e, dzk = h_env[:, k], hsat_env[:, k], dz[:, k]
        start_here = kb == k
        h_u = torch.where(start_here, h_base, h_u)
        started = started | start_here
        ent = torch.exp(-ENTRAINMENT * dzk)
        h_next = h_e + (h_u - h_e) * ent
        h_u = torch.where(started & (k <= kb), h_next, h_u)
        h_us[k] = h_u
        buoys[k] = started & (h_u > hs_e)
    h_u = torch.stack(h_us, dim=1)
    buoyant = torch.stack(buoys, dim=1)

    ktop = torch.where(buoyant, karr, nz).amin(dim=1)
    active_col = (ktop < kb - 1) & (ktop < nz)
    in_cloud = (karr >= ktop[:, None]) & (karr <= kb[:, None])
    cape = torch.where(
        buoyant, (h_u - hsat_env) / (CP_AIR * t) * GRAV * dz, 0.0
    ).sum(dim=1)
    fire = active_col & (cape > CAPE_TRIGGER)

    rho_b = _at_level(p / (RDGAS * tv), kb)
    w_star = torch.sqrt(2.0 * torch.clamp_min(cape, 0.0))
    mb = rho_b * w_star * (dt / TAU_SAS)
    min_dp = torch.where(in_cloud, delp, torch.inf).amin(dim=1)
    mb = torch.minimum(mb, MAX_COURANT * min_dp / (GRAV * dt))
    mb = torch.where(fire, mb, 0.0)

    s_env = CP_AIR * t + GRAV * z
    mbk = mb[:, None]
    flux_mask = (karr >= ktop[:, None]) & (karr < kb[:, None])

    def sub_tend(x):
        fl = torch.where(flux_mask, mbk * x, 0.0)
        gain = torch.cat([torch.zeros_like(fl[:, :1]), fl[:, :-1]], dim=1)
        return (gain - fl) * GRAV / delp

    dq_sub = sub_tend(qv)
    ds_sub = sub_tend(s_env)

    base_sel = (karr == kb[:, None]).to(t.dtype)
    top_sel = (karr == ktop[:, None]).to(t.dtype)
    g_dp = GRAV / delp
    dq_up = -mbk * q_base[:, None] * base_sel * g_dp
    ds_up = -mbk * _at_level(s_env, kb)[:, None] * base_sel * g_dp
    q_top_sat = _at_level(qsat(t, p), ktop % nz)
    q_det = torch.minimum(q_base, q_top_sat)
    cond = torch.clamp_min(q_base - q_det, 0.0)
    s_det = h_base - LV * q_det
    dq_up = dq_up + mbk * q_det[:, None] * top_sel * g_dp
    ds_up = ds_up + mbk * s_det[:, None] * top_sel * g_dp

    qv_new = qv + (dq_sub + dq_up) * dt
    s_new = s_env + (ds_sub + ds_up) * dt
    t_new = (s_new - GRAV * z) / CP_AIR
    precip = mb * cond

    clipped = torch.clamp_min(-qv_new, 0.0)
    qv_new = qv_new + clipped
    t_new = t_new - LV * clipped / CP_AIR
    return t_new, qv_new, precip, fire


def shallow_convection(t, qv, p, delp, dt):
    """Non-precipitating shallow convective mixing of the lowest
    SHALLOW_DEPTH_PA toward a well-mixed moist static energy profile:
    (t_new, qv_new, diags)."""
    ps = p[:, -1:]
    in_layer = (ps - p) < SHALLOW_DEPTH_PA
    w = torch.where(in_layer, delp, 0.0)
    wsum = torch.clamp_min(w.sum(dim=1, keepdim=True), 1.0)
    dz = (RDGAS * t / GRAV) * delp / p
    below = torch.flip(
        torch.cumsum(torch.flip(dz, dims=[1]), dim=1), dims=[1]
    ) - dz
    z_mid = below + 0.5 * dz
    h = CP_AIR * t + LV * qv + GRAV * z_mid
    h_mean = (h * w).sum(dim=1, keepdim=True) / wsum
    unstable = (h[:, -1:] - h_mean) > SHALLOW_CAPE_MIN
    frac = (1.0 - math.exp(-dt / SHALLOW_TAU)) * unstable.to(t.dtype)
    qv_mean = (qv * w).sum(dim=1, keepdim=True) / wsum
    dq = torch.where(in_layer, frac * (qv_mean - qv), 0.0)
    dh = torch.where(in_layer, frac * (h_mean - h), 0.0)
    qv_new = qv + dq
    t_new = t + (dh - LV * dq) / CP_AIR
    diags = {
        "shallow_convection_active": unstable.to(t.dtype).squeeze(1),
    }
    return t_new, qv_new, diags


# --- GFDL 6-category microphysics (gfdl_mp.py) -------------------------------

def esat_liquid(t):
    tc = t - 273.15
    return 611.2 * torch.exp(17.67 * tc / (tc + 243.5))


def esat_ice(t):
    tc = t - 273.15
    return 611.2 * torch.exp(21.87 * tc / (tc + 265.5))


def _qsat_mp(es, p):
    es = torch.minimum(es, 0.99 * p)
    return EPS * es / (p - (1.0 - EPS) * es)


def liquid_fraction(t):
    """Mixed-phase partition: 1 above freezing, 0 below T_ICE_ALL."""
    return torch.clip((t - T_ICE_ALL) / (T_FREEZE - T_ICE_ALL), 0.0, 1.0)


def saturation_adjustment(t, qv, ql, qi, p, iters):
    """Condense or evaporate to the mixed-phase saturation point."""
    for _ in range(iters):
        fl = liquid_fraction(t)
        lheat = fl * LV + (1.0 - fl) * LS
        qs_l = _qsat_mp(esat_liquid(t), p)
        qs_i = _qsat_mp(esat_ice(t), p)
        qs = fl * qs_l + (1.0 - fl) * qs_i
        dqsdt = qs * 17.67 * 243.5 / (t - 273.15 + 243.5) ** 2
        excess = (qv - qs) / (1.0 + (lheat / CP_AIR) * dqsdt)
        cond = torch.clamp_min(excess, 0.0)
        evap_l = torch.minimum(ql, torch.clamp_min(-excess, 0.0))
        evap_i = torch.minimum(qi, torch.clamp_min(-excess - evap_l, 0.0))
        qv = qv - cond + evap_l + evap_i
        ql = ql + fl * cond - evap_l
        qi = qi + (1.0 - fl) * cond - evap_i
        t = t + (
            LV * (fl * cond - evap_l)
            + LS * ((1.0 - fl) * cond - evap_i)
        ) / CP_AIR
    return t, qv, ql, qi


def _sediment(q, delp, dz, v, dt):
    """Implicit upwind fall, top -> bottom: (q_new, surface flux
    [kg/m^2 per dt])."""
    frac = torch.clip(v * dt / torch.clamp_min(dz, 1.0), 0.0, 1.0)
    mass = q * delp / GRAV
    flux = torch.zeros_like(mass[:, 0])
    kept = []
    for k in range(mass.shape[1]):
        mm = mass[:, k] + flux
        flux = mm * frac[:, k]
        kept.append(mm - flux)
    q_new = torch.stack(kept, dim=1) * GRAV / delp
    return q_new, flux


def gfdl_cloud_microphysics(t, qv, ql, qi, qr, qs, qg, p, delp, dz, dt):
    """One microphysics step: (state of the 7 fields, diags with the
    surface precipitation of rain, snow and graupel [kg/m^2 over dt])."""
    dt = torch.full((), dt, dtype=t.dtype, device=t.device)

    t, qv, ql, qi = saturation_adjustment(t, qv, ql, qi, p, SAT_ADJ_ITERS)

    frz = torch.where(t < T_ICE_ALL, ql, 0.0)
    ql = ql - frz
    qi = qi + frz
    t = t + LF * frz / CP_AIR
    mlt = torch.where(t > T_FREEZE, qi, 0.0)
    qi = qi - mlt
    ql = ql + mlt
    t = t - LF * mlt / CP_AIR

    a_l2r = torch.clamp_min(ql - QL0_AUTO, 0.0) * (
        1.0 - torch.exp(-dt / TAU_L2R)
    )
    a_i2s = torch.clamp_min(qi - QI0_AUTO, 0.0) * (
        1.0 - torch.exp(-dt / TAU_I2S)
    )
    ql = ql - a_l2r
    qr = qr + a_l2r
    qi = qi - a_i2s
    qs = qs + a_i2s

    acc_r = ql * -torch.expm1(-C_ACC_RAIN * 1e3 * qr * dt)
    acc_s = qi * -torch.expm1(-C_ACC_SNOW * 1e3 * qs * dt)
    ql = ql - acc_r
    qr = qr + acc_r
    qi = qi - acc_s
    qs = qs + acc_s

    warm = torch.clip((t - T_FREEZE) / 5.0, 0.0, 1.0)
    melt_s = qs * warm * (1.0 - torch.exp(-dt / TAU_MELT))
    melt_g = qg * warm * (1.0 - torch.exp(-dt / TAU_MELT))
    qs = qs - melt_s
    qg = qg - melt_g
    qr = qr + melt_s + melt_g
    t = t - LF * (melt_s + melt_g) / CP_AIR
    cold = torch.clip((T_FREEZE - t) / 5.0, 0.0, 1.0)
    frz_r = qr * cold * (1.0 - torch.exp(-dt / TAU_FRZ))
    qr = qr - frz_r
    qg = qg + frz_r
    t = t + LF * frz_r / CP_AIR

    qs_l = _qsat_mp(esat_liquid(t), p)
    subsat = torch.clip(
        (qs_l - qv) / torch.clamp_min(qs_l, 1e-10), 0.0, 1.0
    )
    revap = qr * subsat * (1.0 - torch.exp(-dt / TAU_REVAP))
    qr = qr - revap
    qv = qv + revap
    t = t - LV * revap / CP_AIR

    qr, rain = _sediment(qr, delp, dz, V_RAIN, dt)
    qs, snow = _sediment(qs, delp, dz, V_SNOW, dt)
    qg, graupel = _sediment(qg, delp, dz, V_GRAUPEL, dt)

    state = {
        "air_temperature": t,
        "specific_humidity": qv,
        "cloud_water_mixing_ratio": ql,
        "cloud_ice_mixing_ratio": qi,
        "rain_mixing_ratio": qr,
        "snow_mixing_ratio": qs,
        "graupel_mixing_ratio": qg,
    }
    diags = {
        "rain_precipitation": rain,
        "snow_precipitation": snow,
        "graupel_precipitation": graupel,
        "total_precipitation_mp": rain + snow + graupel,
    }
    return state, diags


# --- gray radiation (radiation.py RadiationDriver) ---------------------------

def solar_constant(time) -> float:
    """``RadiationDriver.radupdate``: the annual cycle of the earth-sun
    distance in the solar constant."""
    doy = time.timetuple().tm_yday
    return SOLAR_CONSTANT * (
        1.0 + 0.034 * math.cos(2 * math.pi * (doy - 3) / 365.25)
    )


def gray_radiation(cosz, p_lay, delp, temp, sphum, tsfc, solcon):
    """``RadiationDriver._core``: gray shortwave absorption along the
    slant path and an emissivity-weighted longwave exchange."""
    colmass = delp.sum(dim=1, keepdim=True)
    dtau = SW_TAU0 * (delp / colmass) * (1.0 + 20.0 * sphum)
    slant = 1.0 / torch.clamp_min(cosz, 0.05)[:, None]
    trans = torch.exp(-torch.cumsum(dtau, dim=1) * slant)
    toa_down = solcon * cosz
    flux_dn = toa_down[:, None] * torch.cat(
        [torch.ones_like(trans[:, :1]), trans], dim=1
    )
    sfc_down = flux_dn[:, -1]
    absorbed = flux_dn[:, :-1] - flux_dn[:, 1:]
    sw_heating = GRAV * absorbed / (CP_AIR * delp)
    sfc_net_sw = sfc_down * (1.0 - ALBEDO)

    dtau_lw = LW_TAU0 * (delp / colmass) * (1.0 + 50.0 * sphum)
    eps = 1.0 - torch.exp(-dtau_lw)
    sigma_t4 = STEFAN_BOLTZMANN * temp ** 4
    below = _rev_cumsum(dtau_lw) - dtau_lw
    sfc_down_lw = (eps * sigma_t4 * torch.exp(-below)).sum(dim=1)
    up_sfc = STEFAN_BOLTZMANN * tsfc ** 4
    above = torch.cumsum(dtau_lw, dim=1) - dtau_lw
    lw_cooling = (
        -GRAV * eps * sigma_t4 * torch.exp(-above) / (CP_AIR * delp)
    )
    return {
        "total_sky_downward_shortwave_flux_at_surface": sfc_down,
        "total_sky_net_shortwave_flux_at_surface": sfc_net_sw,
        "total_sky_downward_longwave_flux_at_surface": sfc_down_lw,
        "total_sky_upward_longwave_flux_at_surface": up_sfc,
        "shortwave_heating_rate": sw_heating,
        "longwave_heating_rate": lw_cooling,
        "total_sky_downward_shortwave_flux_at_top_of_atmosphere": toa_down,
    }


# --- the suite (gfs.py gfs_physics_step) -------------------------------------

def gfs_physics_step(
    t, qv, qc, u_d, v_d, delp, tsfc, ptop, dt, mp_tracers,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One step of the configuration's suite: surface exchange and PBL,
    SAS and shallow convection, GFDL microphysics over the six
    prognostic species (mp_tracers = (qi, qr, qs, qg); qc is the cloud
    liquid).  Fields [6, nz, n, n] (winds D-grid); tsfc [6, n, n].
    Returns (new_state, diagnostics)."""
    shape2d = t.shape[:1] + t.shape[2:]
    zeros2d = dict(dtype=t.dtype, device=t.device)

    pe, p = pressure_fields(delp, ptop)
    dz, z_mid = layer_geometry(t, qv, delp, pe)
    mass = delp / GRAV
    ua, va = _to_agrid(u_d, v_d)
    diags: Dict[str, torch.Tensor] = {}

    # surface exchange and PBL
    cdm, cdh, ustar, qs_sfc, _ = surface_exchange(
        t[:, -1], qv[:, -1], ua[:, -1], va[:, -1],
        pe[:, -1], p[:, -1], z_mid[:, -1], tsfc,
    )
    rho_sfc = pe[:, -1] / (RDGAS * t[:, -1] * (1 + ZVIR * qv[:, -1]))
    th = t * (1.0e5 / p) ** (RDGAS / CP_AIR)
    thv = th * (1.0 + ZVIR * qv)
    h = pbl_height(thv, z_mid, ua, va)
    z_if_int = z_mid[:, :-1] * 0.5 + z_mid[:, 1:] * 0.5
    k_if = k_profile(z_if_int, h, ustar)
    rho_if = 0.5 * (
        p[:, :-1] / (RDGAS * t[:, :-1])
        + p[:, 1:] / (RDGAS * t[:, 1:])
    )
    dz_if = 0.5 * (dz[:, :-1] + dz[:, 1:])
    g_if = rho_if * k_if / dz_if
    sfc_g_h = rho_sfc * cdh
    sfc_g_m = rho_sfc * cdm
    s = CP_AIR * t + GRAV * z_mid
    s_sfc = CP_AIR * tsfc
    zero_sfc = torch.zeros(shape2d, **zeros2d)
    s_new = diffuse_column(s, mass, g_if, dt, sfc_g_h, s_sfc)
    qv_new = diffuse_column(qv, mass, g_if, dt, sfc_g_h, qs_sfc)
    ua_new = diffuse_column(ua, mass, g_if, dt, sfc_g_m, zero_sfc)
    va_new = diffuse_column(va, mass, g_if, dt, sfc_g_m, zero_sfc)
    shf = sfc_g_h * (s_sfc - s_new[:, -1])
    lhf = sfc_g_h * (qs_sfc - qv_new[:, -1]) * LATENT_HEAT_VAPORIZATION
    t = (s_new - GRAV * z_mid) / CP_AIR
    qv = qv_new
    du_d, dv_d = _tendency_to_dgrid(ua_new - ua, va_new - va)
    u_d = u_d + du_d
    v_d = v_d + dv_d

    # deep and shallow convection
    t, qv, precip_conv, fired = sas_mass_flux(t, qv, p, pe, delp, dt)
    t, qv, sc_diags = shallow_convection(t, qv, p, delp, dt)
    diags.update(sc_diags)

    # GFDL microphysics, the four hydrometeors prognostic
    qi0, qr0, qs0, qg0 = mp_tracers
    mp_state, mp_diags = gfdl_cloud_microphysics(
        t, qv, qc, qi0, qr0, qs0, qg0, p, delp, dz, dt,
    )
    t = mp_state["air_temperature"]
    qv = mp_state["specific_humidity"]
    qc = mp_state["cloud_water_mixing_ratio"]
    diags.update({
        k: mp_diags[k]
        for k in ("rain_precipitation", "snow_precipitation",
                  "graupel_precipitation")
    })
    precip_ls = mp_diags["total_precipitation_mp"]

    state = {
        "air_temperature": t,
        "specific_humidity": qv,
        "cloud_water_mixing_ratio": qc,
        "u_dgrid": u_d,
        "v_dgrid": v_d,
    }
    state.update({k: mp_state[k] for k in MP_TRACER_NAMES})
    diags.update(
        sensible_heat_flux=shf,
        latent_heat_flux=lhf,
        planetary_boundary_layer_height=h,
        convective_precipitation=precip_conv,
        large_scale_precipitation=precip_ls,
        total_precipitation=precip_conv + precip_ls,
        sas_fired=fired,
    )
    return state, diags
