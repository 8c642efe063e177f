"""Minimal Noah-style land-surface model (4 soil layers), in PyTorch (the
JAX package's ``physics/land.py``).

The role of the GFS suite's Noah LSM: a prognostic land state (4-layer
soil temperature and moisture on the Noah layer thicknesses, skin
temperature, canopy water, snow water equivalent) advanced by a
linearized surface energy balance plus implicit soil heat diffusion and a
beta-limited bucket hydrology.  Elementwise over [6, n, n] (or any)
grids; the 4-layer tridiagonal solve is unrolled.  Nothing in the JAX
package steps it, so it has no caller here either; its tests hold it.

Physics kept (and tested):
- surface energy balance: Rnet = SW(1-albedo) + LW_d - eps*sigma*T^4
  partitioned into sensible, latent (beta-limited), and ground heat
  flux, with the skin temperature solved implicitly from the
  linearized balance (energy closure to roundoff)
- soil heat diffusion: implicit 4-layer solve, fixed deep temperature
- hydrology: infiltration from precip, evapotranspiration drawn from
  the root zone, drainage above field capacity
- snow: accumulation below freezing, melt limited by available energy
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import torch

from ..constants import CP_AIR, LATENT_HEAT_VAPORIZATION, RDGAS
from ..device import default_device

SIGMA_SB = 5.670374419e-8
RHO_WATER = 1000.0
LATENT_HEAT_FUSION = 3.34e5
# Noah soil layer thicknesses (m)
DZ_SOIL = (0.10, 0.30, 0.60, 1.00)


@dataclasses.dataclass(frozen=True)
class LandConfig:
    albedo: float = 0.2
    emissivity: float = 0.95
    soil_conductivity: float = 1.1  # W/m/K (loam-ish)
    soil_heat_capacity: float = 2.2e6  # J/m^3/K
    smc_max: float = 0.45  # porosity (m^3/m^3)
    smc_ref: float = 0.30  # field capacity
    smc_wilt: float = 0.10  # wilting point
    drain_time: float = 2.0 * 86400.0  # drainage timescale (s)
    t_deep: float = 288.0  # fixed deep soil temperature (K)
    snow_albedo: float = 0.7


class LandState(NamedTuple):
    """Per-cell prognostic land fields (broadcastable grids)."""

    tskin: torch.Tensor  # skin temperature (K)
    stc: torch.Tensor  # soil temperature [4, ...] (K)
    smc: torch.Tensor  # volumetric soil moisture [4, ...] (m3/m3)
    canopy: torch.Tensor  # canopy water (kg/m^2)
    snow: torch.Tensor  # snow water equivalent (kg/m^2)

    @classmethod
    def initial(cls, shape, t0=288.0, smc0=0.25, dtype=torch.float32,
                device=None):
        """A uniform state on `device` (the CUDA device unless the caller
        names another)."""
        if device is None:
            device = default_device("LandState.initial")
        kw = dict(dtype=dtype, device=device)
        shape4 = (4,) + tuple(shape)
        return cls(
            tskin=torch.full(tuple(shape), t0, **kw),
            stc=torch.full(shape4, t0, **kw),
            smc=torch.full(shape4, smc0, **kw),
            canopy=torch.zeros(tuple(shape), **kw),
            snow=torch.zeros(tuple(shape), **kw),
        )


def _beta_factor(smc_root, cfg: LandConfig):
    """Evapotranspiration efficiency from root-zone soil moisture."""
    return torch.clip(
        (smc_root - cfg.smc_wilt) / (cfg.smc_ref - cfg.smc_wilt),
        0.0, 1.0,
    )


def _soil_heat_implicit(stc, tskin_new, dt, cfg: LandConfig):
    """Implicit 4-layer diffusion with the (new) skin temperature as
    the top boundary and t_deep at the bottom.  Unrolled Thomas solve
    (statically 4 layers)."""
    dz = DZ_SOIL
    k = cfg.soil_conductivity
    c = cfg.soil_heat_capacity
    # interface conductances (top bc to skin, bottom bc to t_deep)
    g = [2.0 * k / (dz[0])]  # skin <-> layer 1
    for i in range(3):
        g.append(2.0 * k / (dz[i] + dz[i + 1]))
    g.append(2.0 * k / dz[3])  # layer 4 <-> deep
    a = [0.0] * 4  # sub-diagonal
    b = [0.0] * 4
    cc = [0.0] * 4  # super-diagonal
    d = [None] * 4
    for i in range(4):
        cap = c * dz[i] / dt
        up = g[i]
        dn = g[i + 1]
        a[i] = -up if i > 0 else 0.0
        cc[i] = -dn if i < 3 else 0.0
        b[i] = cap + up + dn
        rhs = cap * stc[i]
        if i == 0:
            rhs = rhs + g[0] * tskin_new
        if i == 3:
            rhs = rhs + g[4] * cfg.t_deep
        d[i] = rhs
    # forward sweep
    for i in range(1, 4):
        w = a[i] / b[i - 1]
        b[i] = b[i] - w * cc[i - 1]
        d[i] = d[i] - w * d[i - 1]
    x = [None] * 4
    x[3] = d[3] / b[3]
    for i in range(2, -1, -1):
        x[i] = (d[i] - cc[i] * x[i + 1]) / b[i]
    ground_flux = g[0] * (tskin_new - x[0])
    return torch.stack(x), ground_flux


def land_step(
    state: LandState,
    t1, q1, p_sfc, wind1,
    sw_down, lw_down, precip,
    ch,  # surface exchange conductance * |U| [m/s]
    dt: float,
    cfg: LandConfig = LandConfig(),
) -> Tuple[LandState, Dict[str, torch.Tensor]]:
    """Advance the land state one step.

    t1/q1: lowest-layer air temperature (K) / humidity; p_sfc surface
    pressure (Pa); wind1 lowest-layer speed; sw_down/lw_down downward
    radiative fluxes (W/m^2); precip surface precipitation rate
    (kg/m^2/s); ch bulk conductance (m/s) from the surface layer.
    Returns (new_state, fluxes) with fluxes in W/m^2 positive upward
    into the atmosphere.
    """
    from .gfs import dqsat_dt, qsat

    rho = p_sfc / (RDGAS * t1)
    snow_frac = torch.clip(state.snow / 10.0, 0.0, 1.0)
    albedo = cfg.albedo + (cfg.snow_albedo - cfg.albedo) * snow_frac
    eps = cfg.emissivity
    beta = _beta_factor(state.smc[0] * 0.5 + state.smc[1] * 0.5, cfg)

    ts0 = state.tskin
    qs0 = qsat(ts0, p_sfc)
    dqs = dqsat_dt(ts0, p_sfc)
    g0 = 2.0 * cfg.soil_conductivity / DZ_SOIL[0]
    lv = LATENT_HEAT_VAPORIZATION

    # linearized surface energy balance about ts0:
    #   Rnet(T) = H(T) + LE(T) + G(T)
    # with Rnet = SW(1-a) + eps*LWd - eps*sigma*T^4
    rnet0 = sw_down * (1.0 - albedo) + eps * lw_down - (
        eps * SIGMA_SB * ts0 ** 4
    )
    h0 = rho * CP_AIR * ch * (ts0 - t1)
    le0 = rho * lv * ch * beta * (qs0 - q1)
    gf0 = g0 * (ts0 - state.stc[0])
    f0 = rnet0 - h0 - le0 - gf0
    dfdT = (
        -4.0 * eps * SIGMA_SB * ts0 ** 3
        - rho * CP_AIR * ch
        - rho * lv * ch * beta * dqs
        - g0
    )
    ts_new = ts0 - f0 / dfdT
    # freezing cap while snow is present
    ts_new = torch.where(
        (state.snow > 0.0) & (ts_new > 273.16), 273.16, ts_new
    )

    # fluxes at the new skin temperature (consistent linearization)
    shf = rho * CP_AIR * ch * (ts_new - t1)
    evap = rho * ch * beta * (qs0 + dqs * (ts_new - ts0) - q1)
    evap = torch.clamp_min(evap, 0.0)
    lhf = lv * evap
    stc_new, ground = _soil_heat_implicit(state.stc, ts_new, dt, cfg)

    # snow: accumulate frozen precip, melt with residual energy
    freezing = t1 < 273.16
    snow_in = torch.where(freezing, precip, 0.0)
    rain_in = torch.where(freezing, 0.0, precip)
    melt_energy = torch.clamp_min(
        sw_down * (1.0 - albedo) + eps * lw_down
        - eps * SIGMA_SB * ts_new ** 4 - shf - lhf - ground,
        0.0,
    )
    melt = torch.minimum(
        torch.where(state.snow > 0.0, melt_energy / LATENT_HEAT_FUSION,
                  0.0),
        (state.snow + snow_in * dt) / dt,
    )
    snow_new = state.snow + (snow_in - melt) * dt

    # hydrology: infiltration to layer 1, ET from root zone, drainage
    smc = state.smc
    infil = (rain_in + melt) * dt / (RHO_WATER * DZ_SOIL[0])
    et_draw = evap * dt / RHO_WATER
    d1 = et_draw * 0.5 / DZ_SOIL[0]
    d2 = et_draw * 0.5 / DZ_SOIL[1]
    drain = torch.clamp_min(smc - cfg.smc_ref, 0.0) * (
        dt / cfg.drain_time
    )
    smc_new = torch.stack([
        smc[0] + infil - d1 - drain[0],
        smc[1] + drain[0] * DZ_SOIL[0] / DZ_SOIL[1] - d2 - drain[1],
        smc[2] + drain[1] * DZ_SOIL[1] / DZ_SOIL[2] - drain[2],
        smc[3] + drain[2] * DZ_SOIL[2] / DZ_SOIL[3] - drain[3],
    ])
    runoff = torch.clamp_min(smc_new[0] - cfg.smc_max, 0.0) * DZ_SOIL[0]
    smc_new = torch.clip(smc_new, 0.0, cfg.smc_max)

    new = LandState(
        tskin=ts_new,
        stc=stc_new,
        smc=smc_new,
        canopy=state.canopy,
        snow=torch.clamp_min(snow_new, 0.0),
    )
    fluxes = {
        "sensible_heat_flux_land": shf,
        "latent_heat_flux_land": lhf,
        "ground_heat_flux": ground,
        "net_radiation_land": sw_down * (1.0 - albedo)
        + eps * lw_down - eps * SIGMA_SB * ts_new ** 4,
        "snow_melt": melt,
        "surface_runoff": runoff * RHO_WATER / dt,
        "evapotranspiration": evap,
        "beta_factor": beta,
    }
    return new, fluxes
