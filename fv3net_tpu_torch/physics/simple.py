"""Simple column physics: Held-Suarez forcing and saturation adjustment
(the JAX package's ``physics/simple.py``).

The saturation adjustment, the physics of the "simple" suite, is a
Zhao-Carr-style large-scale condensation: condense supersaturation,
evaporate cloud in subsaturated air, autoconvert cloud to rain that falls
out at once as surface precipitation.  Both run as tensor code on the
state's device.
"""

from __future__ import annotations

import math

import torch

from ..constants import (
    CP_AIR,
    GRAV,
    LATENT_HEAT_VAPORIZATION,
    RDGAS,
    RVGAS,
)

SEC_PER_DAY = 86400.0


def held_suarez_tendencies(temp, u, v, pe, lat, dt):
    """Held & Suarez (1994) idealized forcing.

    temp: [6, nz, n, n] (K); u, v: D-grid winds; pe: interface pressures
    [6, nz+1, n, n]; lat: [6, n, n] (radians).
    Returns (dT, du, dv) increments over dt.
    """
    p_lay = 0.5 * (pe[:, 1:] + pe[:, :-1])
    ps = pe[:, -1:]
    sigma = p_lay / ps
    coslat = torch.cos(lat)[:, None]
    sinlat = torch.sin(lat)[:, None]

    # equilibrium temperature
    p0 = 1.0e5
    t_eq = (315.0 - 60.0 * sinlat ** 2
            - 10.0 * torch.log(p_lay / p0) * coslat ** 2) * (
        p_lay / p0
    ) ** (RDGAS / CP_AIR)
    t_eq = torch.clamp_min(t_eq, 200.0)

    k_a = 1.0 / (40.0 * SEC_PER_DAY)
    k_s = 1.0 / (4.0 * SEC_PER_DAY)
    k_f = 1.0 / SEC_PER_DAY
    sigma_b = 0.7
    wt = torch.clip((sigma - sigma_b) / (1.0 - sigma_b), 0.0, 1.0)
    k_t = k_a + (k_s - k_a) * wt * coslat ** 4
    dT = -k_t * (temp - t_eq) * dt

    # Rayleigh friction below sigma_b (approximate sigma at wind points
    # by the cell values averaged to edges)
    k_v = k_f * wt  # [6, nz, n, n]
    kv_u = torch.cat(
        [k_v[:, :, :1], 0.5 * (k_v[:, :, 1:] + k_v[:, :, :-1]),
         k_v[:, :, -1:]], dim=2,
    )
    kv_v = torch.cat(
        [k_v[:, :, :, :1], 0.5 * (k_v[:, :, :, 1:] + k_v[:, :, :, :-1]),
         k_v[:, :, :, -1:]], dim=3,
    )
    du = -kv_u * u * dt
    dv = -kv_v * v * dt
    return dT, du, dv


def saturation_vapor_pressure(temp):
    """Bolton-style es(T) over liquid (Pa)."""
    tc = temp - 273.15
    return 611.2 * torch.exp(17.67 * tc / (tc + 243.5))


def saturation_specific_humidity(temp, p):
    es = saturation_vapor_pressure(temp)
    eps = RDGAS / RVGAS
    es = torch.minimum(es, 0.99 * p)
    return eps * es / (p - (1.0 - eps) * es)


def saturation_adjustment(temp, qv, qc, p_lay, delp, dt,
                          tau_autoconv=3600.0):
    """Condensation iterated twice with latent heating, then
    autoconversion.  Returns (temp, qv, qc, precip [kg/m^2 over dt])."""
    lv_cp = LATENT_HEAT_VAPORIZATION / CP_AIR
    for _ in range(2):
        qs = saturation_specific_humidity(temp, p_lay)
        dqsdT = qs * 17.67 * 243.5 / (temp - 273.15 + 243.5) ** 2
        excess = (qv - qs) / (1.0 + lv_cp * dqsdT)
        cond = torch.where(excess > 0.0, excess, 0.0)
        evap = torch.where(excess < 0.0, torch.minimum(qc, -excess), 0.0)
        qv = qv - cond + evap
        qc = qc + cond - evap
        temp = temp + lv_cp * (cond - evap)
    rain = qc * (1.0 - math.exp(-dt / tau_autoconv))
    qc = qc - rain
    precip = (rain * delp / GRAV).sum(dim=1)  # column integral kg/m^2
    return temp, qv, qc, precip
