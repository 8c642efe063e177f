"""GFDL-style 6-category bulk cloud microphysics (reduced order), in
PyTorch (the JAX package's ``physics/gfdl_mp.py``).

The reference's namelist runs the in-dycore GFDL cloud microphysics
alongside ``do_sat_adj: true``.  The scheme keeps water vapor, cloud
liquid, cloud ice, rain, snow and graupel, with saturation adjustment
(mixed-phase ramp), autoconversion, accretion, freezing/melting, rain
evaporation, and implicit upwind sedimentation per column.

The JAX package's ``lax.scan`` down the levels of ``_sediment`` is a
Python loop over nz here with the same carry and the same order of
operations, each step one [6, n, n] tensor operation.  Conservation
contracts (held in ``tests/test_torch_gfdl.py``): column total water is
conserved to roundoff against surface precipitation, and column moist
energy cp*T + Lv*qv - Lf*(ice phases) against the latent heat of frozen
precipitation leaving the column.  Fields [..., nz, ...] with the level
axis at ``dim=1``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..constants import (
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
T_FREEZE = 273.16
T_ICE_ALL = 233.16  # below: all condensate freezes (homogeneous)
EPS = RDGAS / RVGAS


@dataclasses.dataclass(frozen=True)
class GFDLMPConfig:
    """Process tunables (gfdl_cloud_microphys.F90 namelist analogue)."""

    ql0_auto: float = 5.0e-4     # liquid autoconversion threshold
    qi0_auto: float = 1.0e-4     # ice -> snow threshold
    tau_l2r: float = 900.0       # liquid -> rain autoconv time (s)
    tau_i2s: float = 1800.0      # ice -> snow time (s)
    c_acc_rain: float = 3.0e-3   # rain accreting liquid (per s per kg/kg)
    c_acc_snow: float = 1.0e-3   # snow accreting ice
    tau_melt: float = 900.0      # snow/graupel melt time at +5 K (s)
    tau_frz: float = 900.0       # rain freeze to graupel at -5 K (s)
    tau_revap: float = 1800.0    # rain evaporation time at RH=0 (s)
    v_rain: float = 6.0          # fall speeds (m/s)
    v_snow: float = 1.0
    v_graupel: float = 4.0
    sat_adj_iters: int = 2


def esat_liquid(t):
    tc = t - 273.15
    return 611.2 * torch.exp(17.67 * tc / (tc + 243.5))


def esat_ice(t):
    tc = t - 273.15
    return 611.2 * torch.exp(21.87 * tc / (tc + 265.5))


def _qsat(es, p):
    es = torch.minimum(es, 0.99 * p)
    return EPS * es / (p - (1.0 - EPS) * es)


def liquid_fraction(t):
    """Mixed-phase partition: 1 above freezing, 0 below T_ICE_ALL."""
    return torch.clip((t - T_ICE_ALL) / (T_FREEZE - T_ICE_ALL), 0.0, 1.0)


def saturation_adjustment(t, qv, ql, qi, p, iters=2):
    """Condense/evaporate to the mixed-phase saturation point."""
    for _ in range(iters):
        fl = liquid_fraction(t)
        lheat = fl * LV + (1.0 - fl) * LS
        qs_l = _qsat(esat_liquid(t), p)
        qs_i = _qsat(esat_ice(t), p)
        qs = fl * qs_l + (1.0 - fl) * qs_i
        dqsdt = qs * 17.67 * 243.5 / (t - 273.15 + 243.5) ** 2
        excess = (qv - qs) / (1.0 + (lheat / CP_AIR) * dqsdt)
        cond = torch.clamp_min(excess, 0.0)
        # evaporate existing condensate where subsaturated
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
    """Implicit upwind fall, top -> bottom, carrying the incoming mass
    flux; returns (q_new, surface_flux [kg/m^2 per dt])."""
    # fraction of the layer's mass leaving through its bottom
    frac = torch.clip(v * dt / torch.clamp_min(dz, 1.0), 0.0, 1.0)
    mass = q * delp / GRAV  # kg/m^2 per layer
    flux = torch.zeros_like(mass[:, 0])
    kept = []
    for k in range(mass.shape[1]):
        mm = mass[:, k] + flux  # incoming mass falls through too
        flux = mm * frac[:, k]
        kept.append(mm - flux)
    q_new = torch.stack(kept, dim=1) * GRAV / delp
    return q_new, flux


def gfdl_cloud_microphysics(
    t, qv, ql, qi, qr, qs, qg, p, delp, dz, dt,
    cfg: GFDLMPConfig = GFDLMPConfig(),
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One microphysics step over columns (level axis 1).

    Returns (state, diags): state holds the 7 updated fields; diags
    carry rain/snow/graupel surface precipitation [kg/m^2 over dt]."""
    # dt in the fields' dtype, as the JAX package casts it
    dt = torch.as_tensor(dt, dtype=t.dtype, device=t.device)

    # 1. saturation adjustment (mixed phase)
    t, qv, ql, qi = saturation_adjustment(
        t, qv, ql, qi, p, cfg.sat_adj_iters
    )

    # 2. homogeneous freezing / melting of cloud condensate
    frz = torch.where(t < T_ICE_ALL, ql, 0.0)
    ql = ql - frz
    qi = qi + frz
    t = t + LF * frz / CP_AIR
    mlt = torch.where(t > T_FREEZE, qi, 0.0)
    qi = qi - mlt
    ql = ql + mlt
    t = t - LF * mlt / CP_AIR

    # 3. autoconversion
    a_l2r = torch.clamp_min(ql - cfg.ql0_auto, 0.0) * (
        1.0 - torch.exp(-dt / cfg.tau_l2r)
    )
    a_i2s = torch.clamp_min(qi - cfg.qi0_auto, 0.0) * (
        1.0 - torch.exp(-dt / cfg.tau_i2s)
    )
    ql = ql - a_l2r
    qr = qr + a_l2r
    qi = qi - a_i2s
    qs = qs + a_i2s

    # 4. accretion, continuous-collection form: with the collector ~
    # constant over one step, dql/dt = -k qr ql integrates exactly to
    # ql * (1 - exp(-k qr dt))
    acc_r = ql * -torch.expm1(-cfg.c_acc_rain * 1e3 * qr * dt)
    acc_s = qi * -torch.expm1(-cfg.c_acc_snow * 1e3 * qs * dt)
    ql = ql - acc_r
    qr = qr + acc_r
    qi = qi - acc_s
    qs = qs + acc_s

    # 5. melt snow/graupel above freezing; freeze rain below
    warm = torch.clip((t - T_FREEZE) / 5.0, 0.0, 1.0)
    melt_s = qs * warm * (1.0 - torch.exp(-dt / cfg.tau_melt))
    melt_g = qg * warm * (1.0 - torch.exp(-dt / cfg.tau_melt))
    qs = qs - melt_s
    qg = qg - melt_g
    qr = qr + melt_s + melt_g
    t = t - LF * (melt_s + melt_g) / CP_AIR
    cold = torch.clip((T_FREEZE - t) / 5.0, 0.0, 1.0)
    frz_r = qr * cold * (1.0 - torch.exp(-dt / cfg.tau_frz))
    qr = qr - frz_r
    qg = qg + frz_r
    t = t + LF * frz_r / CP_AIR

    # 6. rain evaporation in subsaturated air
    qs_l = _qsat(esat_liquid(t), p)
    subsat = torch.clip(
        (qs_l - qv) / torch.clamp_min(qs_l, 1e-10), 0.0, 1.0
    )
    revap = qr * subsat * (1.0 - torch.exp(-dt / cfg.tau_revap))
    qr = qr - revap
    qv = qv + revap
    t = t - LV * revap / CP_AIR

    # 7. sedimentation of precipitating species
    qr, rain = _sediment(qr, delp, dz, cfg.v_rain, dt)
    qs, snow = _sediment(qs, delp, dz, cfg.v_snow, dt)
    qg, graupel = _sediment(qg, delp, dz, cfg.v_graupel, dt)

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
