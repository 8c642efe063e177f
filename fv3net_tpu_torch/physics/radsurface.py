"""Surface albedo and emissivity schemes for radiation.

Counterpart of the JAX package's ``physics/radsurface.py`` (the role of
the reference's setalb/setemis): surface SW albedo from surface type,
snow cover and solar zenith angle, and LW emissivity from surface type
and snow, as torch tensor expressions with grid-shaped broadcasting.

Ocean albedo follows the Briegleb (1986/CCM) direct-beam form used by
the GFS scheme family: alb = 0.026 / (mu^1.7 + 0.065)
+ 0.15 (mu - 0.1)(mu - 0.5)(mu - 1.0) -- ~0.03-0.07 at high sun,
rising steeply toward the horizon.  Snow blends toward a high albedo
with a saturation depth of ~10 kg/m^2 SWE, slightly reduced at high
sun per the GFS fresh-snow zenith correction.  ``land_mask`` and
``snow_swe`` may be numbers or tensors; ``cosz`` is a tensor.
"""

from __future__ import annotations

import torch

OCEAN_EMISSIVITY = 0.984
LAND_EMISSIVITY = 0.95
SNOW_EMISSIVITY = 0.99
SNOW_ALBEDO = 0.75
SNOW_SAT_SWE = 10.0  # kg/m^2 at which snow fully masks the surface


def ocean_albedo(cosz):
    """Briegleb direct-beam ocean albedo as a function of mu0."""
    mu = torch.clamp(cosz, 0.0, 1.0)
    base = 0.026 / (mu ** 1.7 + 0.065)
    glint = 0.15 * (mu - 0.1) * (mu - 0.5) * (mu - 1.0)
    return torch.clamp(base + glint, 0.02, 0.6)


def snow_fraction(snow_swe):
    if isinstance(snow_swe, torch.Tensor):
        return torch.clamp(snow_swe / SNOW_SAT_SWE, 0.0, 1.0)
    return min(max(snow_swe / SNOW_SAT_SWE, 0.0), 1.0)


def surface_albedo(cosz, land_mask=None, snow_swe=0.0,
                   land_albedo=0.2):
    """Broadband SW surface albedo (setalb role).

    cosz: cosine solar zenith [cols]; land_mask: 1 over land, 0 over
    ocean (None = all ocean); snow_swe: snow water equivalent
    (kg/m^2); land_albedo: snow-free land base value (vegetation/soil
    blend).
    """
    ocean = ocean_albedo(cosz)
    if land_mask is None:
        land_mask = torch.zeros_like(ocean)
    sfrac = snow_fraction(snow_swe)
    # fresh-snow zenith correction: slightly darker at high sun
    snow_alb = SNOW_ALBEDO * (
        1.0 - 0.08 * torch.clamp(cosz, 0.0, 1.0)
    )
    land = land_albedo + (snow_alb - land_albedo) * sfrac
    return land_mask * land + (1.0 - land_mask) * ocean


def surface_albedo_spectral(cosz, land_mask=None, snow_swe=0.0,
                            land_albedo_vis=0.12,
                            land_albedo_nir=0.28):
    """Spectral direct/diffuse surface albedo (the full setalb
    contract, radiation_surface.py: sfcalb components
    nir-direct / nir-diffuse / uvvis-direct / uvvis-diffuse).

    Returns a dict with keys 'uvvis_dir', 'uvvis_dif', 'nir_dir',
    'nir_dif'.  Ocean: Briegleb zenith-dependent direct beam + a flat
    0.06 diffuse; land: vegetation/soil VIS-dark NIR-bright split;
    snow: 0.90 VIS / 0.58 NIR with the fresh-snow zenith correction.
    """
    mu = torch.clamp(cosz, 0.0, 1.0)
    ocean_dir = ocean_albedo(cosz)
    ocean_dif = torch.full_like(ocean_dir, 0.06)
    if land_mask is None:
        land_mask = torch.zeros_like(ocean_dir)
    sfrac = snow_fraction(snow_swe)
    zen = 1.0 - 0.08 * mu  # fresh-snow zenith correction
    snow_vis = 0.90 * zen
    snow_nir = 0.58 * zen

    def blend(base, snow_alb):
        land = base + (snow_alb - base) * sfrac
        return land

    out = {}
    for key, land_base, snow_alb, oc in (
        ("uvvis_dir", land_albedo_vis, snow_vis, ocean_dir),
        ("uvvis_dif", land_albedo_vis, snow_vis, ocean_dif),
        ("nir_dir", land_albedo_nir, snow_nir, ocean_dir),
        ("nir_dif", land_albedo_nir, snow_nir, ocean_dif),
    ):
        out[key] = land_mask * blend(land_base, snow_alb) + (
            1.0 - land_mask
        ) * oc
    return out


def surface_emissivity(land_mask=None, snow_swe=0.0):
    """Broadband LW emissivity (setemis role)."""
    sfrac = snow_fraction(snow_swe)
    land = LAND_EMISSIVITY + (SNOW_EMISSIVITY - LAND_EMISSIVITY) * sfrac
    if land_mask is None:
        return OCEAN_EMISSIVITY + 0.0 * land
    return land_mask * land + (1.0 - land_mask) * OCEAN_EMISSIVITY
