"""SAS-style mass-flux deep convection, in PyTorch (the JAX package's
``physics/convection.py``).

The role of the GFS suite's simplified Arakawa-Schubert scheme: an
entraining updraft from the level of maximum moist static energy, a
CAPE-based cloud-base mass-flux closure, compensating environmental
subsidence in exact flux form, and detrainment of the (saturated) updraft
air at cloud top.  The scheme is a mass rearrangement plus condensation,
so the column moist static energy cp*T + L*q (mass-weighted) is conserved
exactly: condensed water leaves as precipitation while its latent heat
stays in the column.

The JAX package's upward ``lax.scan`` on reversed views (``[:, ::-1]``)
is a Python loop over the levels from the bottom here (torch has no
negative strides); everything else is elementwise over [6, nz, n, n].
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..constants import CP_AIR, GRAV, LATENT_HEAT_VAPORIZATION, RDGAS

LV = LATENT_HEAT_VAPORIZATION


@dataclasses.dataclass(frozen=True)
class SASConfig:
    entrainment: float = 1.0e-4  # fractional entrainment (1/m)
    tau_sas: float = 3600.0  # CAPE relaxation timescale (s)
    cape_trigger: float = 100.0  # J/kg minimum CAPE to fire
    max_courant: float = 0.4  # cap on mb*dt*g/delp


def _mse(t, qv, z):
    return CP_AIR * t + GRAV * z + LV * qv


def _heights(t, qv, delp, pe):
    """Layer-mean geopotential heights (hydrostatic, surface z=0)."""
    tv = t * (1.0 + 0.608 * qv)
    dz = RDGAS * tv * delp / (GRAV * 0.5 * (pe[:, 1:] + pe[:, :-1]))
    below = torch.flip(
        torch.cumsum(torch.flip(dz, dims=[1]), dim=1), dims=[1]
    ) - dz
    return below + 0.5 * dz


def _at_level(x, k):
    """x [6, nz, n, n] at the per-column level k [6, n, n]."""
    return torch.gather(x, 1, k[:, None])[:, 0]


def sas_mass_flux(
    t, qv, p, pe, delp, dt: float,
    cfg: SASConfig = SASConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One deep-convection step.  Fields [6, nz, n, n] (k=0 is the model
    top, k=nz-1 the surface layer, matching the dycore).  Returns
    (t_new, qv_new, precip_rate [kg/m^2/s])."""
    from .gfs import qsat

    nz = t.shape[1]
    dev = t.device
    z = _heights(t, qv, delp, pe)
    h_env = _mse(t, qv, z)
    hsat_env = CP_AIR * t + GRAV * z + LV * qsat(t, p)

    # launch layer: maximum MSE in the lowest quarter of the column
    kb0 = 3 * nz // 4
    karr = torch.arange(nz, device=dev)[None, :, None, None]
    h_low = torch.where(karr >= kb0, h_env, -torch.inf)
    kb = torch.argmax(h_low, dim=1)  # [6, n, n], the first maximum
    h_base = h_low.amax(dim=1)
    q_base = _at_level(qv, kb)

    tv = t * (1.0 + 0.608 * qv)
    dz = RDGAS * tv * delp / (GRAV * 0.5 * (pe[:, 1:] + pe[:, :-1]))

    # entraining ascent (bottom -> top): dh_u/dz = -eps*(h_u - h_env)
    h_u = torch.full_like(h_base, -torch.inf)
    started = torch.zeros(h_base.shape, dtype=torch.bool, device=dev)
    h_us, buoys = [None] * nz, [None] * nz
    for k in range(nz - 1, -1, -1):
        h_e, hs_e, dzk = h_env[:, k], hsat_env[:, k], dz[:, k]
        start_here = kb == k
        h_u = torch.where(start_here, h_base, h_u)
        started = started | start_here
        ent = torch.exp(-cfg.entrainment * dzk)
        h_next = h_e + (h_u - h_e) * ent
        h_u = torch.where(started & (k <= kb), h_next, h_u)
        h_us[k] = h_u
        buoys[k] = started & (h_u > hs_e)
    h_u = torch.stack(h_us, dim=1)
    buoyant = torch.stack(buoys, dim=1)

    # cloud top: highest buoyant level; CAPE from parcel-env MSE excess
    ktop = torch.where(buoyant, karr, nz).amin(dim=1)  # nz => no cloud
    active_col = (ktop < kb - 1) & (ktop < nz)
    in_cloud = (karr >= ktop[:, None]) & (karr <= kb[:, None])
    cape = torch.where(
        buoyant, (h_u - hsat_env) / (CP_AIR * t) * GRAV * dz, 0.0
    ).sum(dim=1)
    fire = active_col & (cape > cfg.cape_trigger)

    # closure: relax CAPE over tau -- mb scaled by CAPE, capped by the
    # thinnest in-cloud layer's Courant limit
    rho_b = _at_level(p / (RDGAS * tv), kb)
    w_star = torch.sqrt(2.0 * torch.clamp_min(cape, 0.0))
    mb = rho_b * w_star * (dt / cfg.tau_sas)
    min_dp = torch.where(in_cloud, delp, torch.inf).amin(dim=1)
    mb = torch.minimum(mb, cfg.max_courant * min_dp / (GRAV * dt))
    mb = torch.where(fire, mb, 0.0)  # [6, n, n]

    # compensating subsidence in exact flux form: between ktop and kb
    # the environment moves DOWN by mb; interface flux of X is
    # mb * X(layer above the interface).  The updraft transports base
    # air to the top layer (detrainment), closing the mass circuit.
    s_env = CP_AIR * t + GRAV * z
    mbk = mb[:, None]
    flux_mask = (karr >= ktop[:, None]) & (karr < kb[:, None])

    def sub_tend(x):
        # flux through the bottom interface of layer k, ktop <= k < kb
        fl = torch.where(flux_mask, mbk * x, 0.0)
        # layer k gains fl[k-1] (from above), loses fl[k]
        gain = torch.cat([torch.zeros_like(fl[:, :1]), fl[:, :-1]], dim=1)
        return (gain - fl) * GRAV / delp

    dq_sub = sub_tend(qv)
    ds_sub = sub_tend(s_env)

    # updraft: removes mb of base-layer air, detrains saturated air with
    # the updraft's (entrained) MSE at the top layer
    base_sel = (karr == kb[:, None]).to(t.dtype)
    top_sel = (karr == ktop[:, None]).to(t.dtype)
    g_dp = GRAV / delp
    dq_up = -mbk * q_base[:, None] * base_sel * g_dp
    ds_up = -mbk * _at_level(s_env, kb)[:, None] * base_sel * g_dp
    # detrain at top: moisture at saturation of the top layer; the
    # leftover (q_base - q_det) falls as precipitation
    q_top_sat = _at_level(qsat(t, p), ktop % nz)
    q_det = torch.minimum(q_base, q_top_sat)
    cond = torch.clamp_min(q_base - q_det, 0.0)  # kg/kg condensed
    # the transported air is the undiluted base air: detrained dry
    # static energy s_det = h_base - LV*q_det closes the column MSE
    # budget exactly
    s_det = h_base - LV * q_det
    dq_up = dq_up + mbk * q_det[:, None] * top_sel * g_dp
    ds_up = ds_up + mbk * s_det[:, None] * top_sel * g_dp

    qv_new = qv + (dq_sub + dq_up) * dt
    s_new = s_env + (ds_sub + ds_up) * dt
    t_new = (s_new - GRAV * z) / CP_AIR
    precip = mb * cond  # kg/m^2/s

    # floor humidity; return any clipped moisture's latent heat to T
    clipped = torch.clamp_min(-qv_new, 0.0)
    qv_new = qv_new + clipped
    t_new = t_new - LV * clipped / CP_AIR
    return t_new, qv_new, precip
