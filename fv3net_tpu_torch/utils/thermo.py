"""Thermodynamic utilities (vcm/calc/thermo equivalents; the JAX
package's ``utils/thermo.py``).

Function names and semantics follow the reference's vcm.* exports
(external/vcm/vcm/__init__.py:32-61; calc/thermo/local.py,
vertically_dependent.py) so downstream code ports directly.  All
functions accept numpy arrays or torch tensors (a tensor stays on its
device) and operate along a `z` axis given by keyword (default -3 for
[.., z, y, x] layouts).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import (
    CP_AIR,
    GRAV,
    KAPPA,
    LATENT_HEAT_VAPORIZATION,
    RDGAS,
    REFERENCE_SURFACE_PRESSURE,
    RVGAS,
    ZVIR,
)

TOA_PRESSURE = 300.0


def potential_temperature(p, T):
    """(local.py:21)"""
    return T * (REFERENCE_SURFACE_PRESSURE / p) ** KAPPA


def temperature_from_potential(p, theta):
    return theta * (p / REFERENCE_SURFACE_PRESSURE) ** KAPPA


def density(p, T, q=0.0):
    return p / (RDGAS * T * (1.0 + ZVIR * q))


def virtual_temperature(T, q):
    return T * (1.0 + ZVIR * q)


def _cumsum(a, axis):
    if isinstance(a, torch.Tensor):
        return torch.cumsum(a, dim=axis)
    return np.cumsum(a, axis=axis)


def _concat(parts, axis):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=axis)
    return np.concatenate(parts, axis=axis)


def _flip(a, axis):
    if isinstance(a, torch.Tensor):
        return torch.flip(a, dims=[axis])
    return np.flip(a, axis=axis)


def _exp(a):
    return torch.exp(a) if isinstance(a, torch.Tensor) else np.exp(a)


def _log(a):
    return torch.log(a) if isinstance(a, torch.Tensor) else np.log(a)


def pressure_interface(delp, toa_pressure=TOA_PRESSURE, axis=-3):
    """Interface pressures from layer thicknesses
    (vertically_dependent.py:41)."""
    zeros_shape = list(delp.shape)
    zeros_shape[axis] = 1
    if isinstance(delp, torch.Tensor):
        top = torch.full(zeros_shape, toa_pressure, dtype=delp.dtype,
                         device=delp.device)
    else:
        top = np.full(zeros_shape, toa_pressure, dtype=delp.dtype)
    return _concat([top, toa_pressure + _cumsum(delp, axis)], axis)


def pressure_at_midpoint_log(delp, toa_pressure=TOA_PRESSURE, axis=-3):
    """Layer midpoint pressure via log interpolation."""
    pe = pressure_interface(delp, toa_pressure, axis)
    ndim = pe.ndim
    ax = axis % ndim
    lo = tuple(
        slice(0, -1) if d == ax else slice(None) for d in range(ndim)
    )
    hi = tuple(
        slice(1, None) if d == ax else slice(None) for d in range(ndim)
    )
    return (pe[hi] - pe[lo]) / (_log(pe[hi]) - _log(pe[lo]))


def surface_pressure_from_delp(delp, p_toa=TOA_PRESSURE, axis=-3):
    return delp.sum(axis=axis) + p_toa


def mass_integrate(q, delp, axis=-3):
    """Column integral q dp / g (vertically_dependent.py:18)."""
    return (q * delp).sum(axis=axis) / GRAV


def column_integrated_heating_from_isochoric_transition(
    dtemp_dt, delp, axis=-3
):
    from ..constants import CV_AIR

    return CV_AIR * mass_integrate(dtemp_dt, delp, axis)


def column_integrated_heating_from_isobaric_transition(
    dtemp_dt, delp, axis=-3
):
    return CP_AIR * mass_integrate(dtemp_dt, delp, axis)


def liquid_ice_temperature(T, q_liquid, q_ice=0.0):
    from ..constants import LATENT_HEAT_FUSION

    return (
        T
        - (LATENT_HEAT_VAPORIZATION / CP_AIR) * q_liquid
        - (
            (LATENT_HEAT_VAPORIZATION + LATENT_HEAT_FUSION) / CP_AIR
        ) * q_ice
    )


def net_heating_from_physics(
    column_heating, precip_rate
):
    """(local.py:31 family): net column heating given latent release."""
    return column_heating - LATENT_HEAT_VAPORIZATION * precip_rate


def saturation_vapor_pressure(T):
    tc = T - 273.15
    return 611.2 * _exp(17.67 * tc / (tc + 243.5))


def saturation_mixing_ratio(p, T):
    es = saturation_vapor_pressure(T)
    eps = RDGAS / RVGAS
    d = p - es
    d = torch.clamp_min(d, 1.0) if isinstance(d, torch.Tensor) else \
        np.maximum(d, 1.0)
    return eps * es / d


def relative_humidity_from_pressure(T, q, p):
    """(local.py:246)"""
    qs = saturation_mixing_ratio(p, T)
    return q / qs


def relative_humidity(T, q, rho):
    """(local.py:230): RH from density via vapor partial pressure."""
    e = q * rho * RVGAS * T
    return e / saturation_vapor_pressure(T)


def specific_humidity_from_rh(T, rh, p):
    return rh * saturation_mixing_ratio(p, T)


def moist_static_energy(T, q, z):
    return CP_AIR * T + GRAV * z + LATENT_HEAT_VAPORIZATION * q


def height_at_interface(dz, phis, axis=-3):
    """Interface heights from layer thicknesses (dz negative downward in
    FV3 convention) and surface geopotential."""
    zs = phis / GRAV
    zeros_shape = list(dz.shape)
    zeros_shape[axis] = 1
    ax = axis % dz.ndim
    cum = _flip(_cumsum(_flip(-dz, ax), axis), ax)
    bottom = zs.reshape(zeros_shape)
    return _concat([cum + bottom, bottom], axis)


def mass_streamfunction(northward_wind_pressure_integral):
    from ..constants import RADIUS, PI

    return 2 * PI * RADIUS * northward_wind_pressure_integral / GRAV


# name-compatibility alias with the reference's vcm export
pressure_at_interface = pressure_interface
