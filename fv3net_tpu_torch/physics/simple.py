"""Saturation adjustment: the physics of the compiled loop's "simple"
suite (the JAX package's ``physics/simple.py``, lines 74-112).

A Zhao-Carr-style large-scale condensation: condense supersaturation,
evaporate cloud in subsaturated air, autoconvert cloud to rain that falls
out at once as surface precipitation.  ``held_suarez_tendencies`` of the
same module is not ported (ROADMAP).
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
