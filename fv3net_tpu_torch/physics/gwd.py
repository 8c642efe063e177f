"""Orographic gravity-wave drag and shallow convection, in PyTorch (the
JAX package's ``physics/gwd.py``).

``gravity_wave_drag`` is a McFarlane (1987)-style single-wave scheme
(the GFS gwdps role, reduced order): a low-level wave stress from the
subgrid orography standard deviation, capped by the Froude criterion,
propagates upward until the wave saturates, where the excess deposits as
a decelerating force along the surface-wind direction; the column's
force equals the surface stress less the stress leaving the model top.
The JAX package's ``lax.cummin`` on the reversed level axis is
``torch.cummin`` on a flipped view, flipped back.  ``shallow_convection``
is the GFS shalcnv role.  Fields [.., nz, ..], level axis 1; the drag's
tendencies act on A-grid winds.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..constants import CP_AIR, GRAV, RDGAS
from ..constants import LATENT_HEAT_VAPORIZATION as LV

KAPPA = RDGAS / CP_AIR


@dataclasses.dataclass(frozen=True)
class GWDConfig:
    k_wave: float = 2.0e-5     # horizontal wavenumber (1/m), ~300 km
    froude_crit: float = 1.0   # h_eff cap: N h / U <= Fc
    efficiency: float = 0.35   # fraction of linear stress realized
    u_min: float = 1.0         # floor on |U| (m/s)


def brunt_vaisala(t, p):
    """Dry N^2 on the interfaces between layers (level axis 1) from
    theta differences."""
    theta = t * (1.0e5 / p) ** KAPPA
    dlth = torch.diff(torch.log(theta), dim=1)
    # layer spacing from hydrostatics: |dz| = (R Tbar / g) dlnp
    # (positive: p increases downward so dlnp > 0 along k)
    dz = (RDGAS * 0.5 * (t[:, :-1] + t[:, 1:]) / GRAV) * torch.diff(
        torch.log(p), dim=1
    )
    # k increases downward: theta decreasing with k (dlth < 0) is
    # stable, N^2 = -g dln(theta)/dz > 0
    n2 = -GRAV * dlth / torch.clamp_min(dz, 1.0)
    return torch.clip(n2, 1.0e-8, 1.0e-3)


def gravity_wave_drag(u, v, t, p, delp, h_std, dt,
                      cfg: GWDConfig = GWDConfig()):
    """A-grid wind increments (du, dv) over dt and diagnostics.
    u, v, t, p, delp [.., nz, ..] (k increases downward); h_std the
    subgrid orography standard deviation [.., ..] (no level axis)."""
    # surface-layer (lowest-level) quantities
    us, vs = u[:, -1], v[:, -1]
    spd_s = torch.sqrt(us ** 2 + vs ** 2)
    spd_s_c = torch.clamp_min(spd_s, cfg.u_min)
    ts = t[:, -1]
    ps = p[:, -1]
    rho_s = ps / (RDGAS * ts)
    n2 = brunt_vaisala(t, p)
    n_s = torch.sqrt(n2[:, -1])
    # Froude-capped effective mountain height
    h_eff = torch.minimum(
        h_std, cfg.froude_crit * spd_s_c / torch.clamp_min(n_s, 1e-4)
    )
    tau0 = (
        cfg.efficiency * rho_s * cfg.k_wave * n_s * spd_s_c
        * h_eff ** 2
    )
    # unit vector of the surface wind (wave-parallel drag)
    ex = us / spd_s_c
    ey = vs / spd_s_c

    # saturation stress with Up the wind component along the surface
    # wind: tau_sat = eff * rho * k * Fc^2 * Up^3 / N  (Pa)
    up = u * ex[:, None] + v * ey[:, None]
    up = torch.clamp_min(up, cfg.u_min * 0.1)
    rho = p / (RDGAS * t)
    n_mid = torch.sqrt(torch.cat([n2[:, :1], n2], dim=1))
    tau_sat = (
        cfg.efficiency * rho * cfg.k_wave * cfg.froude_crit ** 2
        * up ** 3 / torch.clamp_min(n_mid, 1e-4)
    )
    # the stress at the top of layer k is min(tau0, min_{j>=k}
    # tau_sat[j]), a running minimum from the bottom; the per-layer
    # convergence tau_bot - tau_top >= 0 decelerates the along-wind
    # component and the column sum telescopes to tau0 - tau_top_of_model
    cfb = torch.flip(
        torch.cummin(torch.flip(tau_sat, dims=[1]), dim=1).values, dims=[1]
    )
    tau_top = torch.minimum(tau0[:, None], cfb)  # [.., nz, ..]
    tau_bot = torch.cat([tau_top[:, 1:], tau0[:, None]], dim=1)
    dtau = tau_bot - tau_top  # stress convergence per layer (>= 0)
    accel = GRAV * dtau / delp  # m/s^2 decelerating along (ex, ey)
    du = -accel * ex[:, None] * dt
    dv = -accel * ey[:, None] * dt
    # never reverse the along-wind component within one step
    limit = torch.abs(up) / torch.clamp_min(
        torch.sqrt(du ** 2 + dv ** 2), 1e-10
    )
    scale = torch.clamp_max(limit, 1.0)
    du = du * scale
    dv = dv * scale
    diags = {
        "gwd_surface_stress": tau0,
        "gwd_top_stress": tau_top[:, 0],
        "gwd_column_drag": (
            torch.sqrt(du ** 2 + dv ** 2) * delp / GRAV
        ).sum(dim=1) / dt,
    }
    return du, dv, diags


def shallow_convection(t, qv, p, delp, dt, depth_pa: float = 2.5e4,
                       tau: float = 3600.0, cape_min: float = 0.0):
    """Non-precipitating shallow convective mixing: where the boundary
    layer is conditionally unstable, relax the lowest ~250 hPa toward a
    well-mixed profile of moist static energy, conserving column
    enthalpy and water exactly.  Returns (t_new, qv_new, diags)."""
    ps = p[:, -1:]
    in_layer = (ps - p) < depth_pa
    w = torch.where(in_layer, delp, 0.0)
    wsum = torch.clamp_min(w.sum(dim=1, keepdim=True), 1.0)
    # moist static energy h = cp*T + Lv*qv + g*z, z from hydrostatic
    # integration (surface = 0)
    dz = (RDGAS * t / GRAV) * delp / p
    below = torch.flip(
        torch.cumsum(torch.flip(dz, dims=[1]), dim=1), dims=[1]
    ) - dz
    z_mid = below + 0.5 * dz
    h = CP_AIR * t + LV * qv + GRAV * z_mid
    h_mean = (h * w).sum(dim=1, keepdim=True) / wsum
    unstable = (h[:, -1:] - h_mean) > cape_min
    frac = (1.0 - math.exp(-dt / tau)) * unstable.to(t.dtype)
    qv_mean = (qv * w).sum(dim=1, keepdim=True) / wsum
    dq = torch.where(in_layer, frac * (qv_mean - qv), 0.0)
    dh = torch.where(in_layer, frac * (h_mean - h), 0.0)
    qv_new = qv + dq
    t_new = t + (dh - LV * dq) / CP_AIR
    diags = {
        "shallow_convection_active": unstable.to(t.dtype).squeeze(1),
    }
    return t_new, qv_new, diags
