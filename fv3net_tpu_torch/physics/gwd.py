"""Shallow convection (the JAX package's ``physics/gwd.py``, lines
136-176; the GFS shalcnv role).  ``gravity_wave_drag`` of the same module
is not ported: the compiled loop never passes the subgrid orography that
turns it on (ROADMAP)."""

from __future__ import annotations

import math

import torch

from ..constants import CP_AIR, GRAV, RDGAS
from ..constants import LATENT_HEAT_VAPORIZATION as LV


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
