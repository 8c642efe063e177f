"""Cloud and aerosol optical properties for the multiband scheme.

Counterpart of the JAX package's ``physics/radclouds.py`` (the role of
the reference's CloudClass progcld diagnosis and AerosolClass
climatology): torch tensor expressions producing per-band (tau, ssa,
asy) tensors that broadcast straight into the two-stream solvers.
Liquid optics follow the Slingo-style 1/r_eff law, ice optics a Fu-style
law; LW emissivity uses mass absorption coefficients.
"""

from __future__ import annotations

import dataclasses

import torch

from ..constants import GRAV
from ..graphs import constant
from .radgases import annual_cos


@dataclasses.dataclass(frozen=True)
class CloudOpticsParams:
    reff_liq: float = 10.0e-6   # m
    reff_ice: float = 30.0e-6   # m
    # SW single-scattering albedo / asymmetry (visible-to-nir averages)
    ssa_liq: float = 0.9995
    ssa_ice: float = 0.9975
    asy_liq: float = 0.85
    asy_ice: float = 0.80
    # LW mass absorption (m^2/kg)
    k_lw_liq: float = 140.0
    k_lw_ice: float = 70.0


def cloud_fraction_from_rh(rh, crit=0.85):
    """Diagnostic (Sundqvist) cloud fraction from relative humidity —
    the role of progcld's cldtot diagnosis (radiation_clouds.py)."""
    x = torch.clamp((rh - crit) / (1.0 - crit), 0.0, 1.0)
    return 1.0 - torch.sqrt(1.0 - x)


def cloud_optics_sw(cwp_liq, cwp_ice, params=CloudOpticsParams()):
    """SW cloud optical depth / ssa / asymmetry from in-cloud water
    paths (kg/m^2).  Geometric-optics limit: tau = 3 W / (2 rho_w r)."""
    tau_l = 1.5 * cwp_liq / (1000.0 * params.reff_liq)
    tau_i = 1.5 * cwp_ice / (917.0 * params.reff_ice)
    tau = tau_l + tau_i
    w = torch.where(
        tau > 0.0,
        (params.ssa_liq * tau_l + params.ssa_ice * tau_i)
        / torch.clamp_min(tau, 1e-30),
        torch.ones_like(tau),
    )
    g = torch.where(
        tau > 0.0,
        (params.asy_liq * tau_l + params.asy_ice * tau_i)
        / torch.clamp_min(tau, 1e-30),
        torch.full_like(tau, 0.85),
    )
    return tau, w, g


def cloud_optics_lw(cwp_liq, cwp_ice, params=CloudOpticsParams()):
    """LW absorption optical depth from in-cloud water paths."""
    return params.k_lw_liq * cwp_liq + params.k_lw_ice * cwp_ice


def condensate_paths(delp, ql, qi):
    """In-cloud water paths per layer from grid-mean condensate mixing
    ratios (kg/kg) and layer thickness (Pa)."""
    air = delp / GRAV
    return ql * air, qi * air


@dataclasses.dataclass(frozen=True)
class AerosolClimatology:
    """Climatological aerosol (AerosolClass role,
    radiation_aerosols.py): latitude- and season-dependent 550 nm
    column optical depth (maritime background + NH continental/dust
    belt with a boreal-summer peak), an exponential vertical profile,
    and Angstrom scaling across SW bands."""

    aod550: float = 0.12  # global fallback when no lat/doy given
    scale_height_pa: float = 2.0e4  # e-folding depth in pressure
    # per-band optics TABLES at the 14 RRTMG band centers
    # (radgases.SW_BAND_RANGE_UM; the radiation_aerosols.py extrhi/
    # extstra table role): extinction via Angstrom (lambda/0.55)^-1.3,
    # single-scattering albedo falling UV->NIR (continental-average
    # OPAC mixture), asymmetry rising with wavelength
    band_scale: tuple = (3.11, 2.20, 1.56, 1.05, 0.73, 0.47, 0.34,
                         0.28, 0.22, 0.18, 0.155, 0.122, 0.092,
                         0.050)
    band_ssa: tuple = (0.95, 0.96, 0.96, 0.96, 0.95, 0.94, 0.93,
                       0.92, 0.91, 0.90, 0.89, 0.87, 0.85, 0.80)
    band_asy: tuple = (0.68, 0.68, 0.69, 0.70, 0.70, 0.71, 0.72,
                       0.72, 0.73, 0.73, 0.74, 0.74, 0.75, 0.76)
    # lat/season climatology (radiation_aerosols climatology role)
    aod_background: float = 0.06  # clean maritime
    aod_belt: float = 0.22  # NH dust/pollution belt amplitude
    belt_lat: float = 25.0  # deg N
    belt_width: float = 18.0  # deg
    belt_season_amp: float = 0.5  # +/- fraction, peak ~day 182

    def aod550_field(self, lat_deg, doy):
        """Column AOD at 550 nm per cell from the latitude belt +
        seasonal cycle (the data-table climatology of
        radiation_aerosols.py collapsed to its leading modes)."""
        lat = lat_deg
        belt = self.aod_belt * torch.exp(
            -0.5 * ((lat - self.belt_lat) / self.belt_width) ** 2
        )
        season = (
            1.0 + self.belt_season_amp * annual_cos(doy, 182.0, lat.device)
        ).to(lat.dtype)
        return self.aod_background + belt * season

    def sw_optics(self, p_lay, delp, aod550=None):
        """Per-layer aerosol (tau[band, nz, ...cols], ssa, asy).

        Level axis is axis 0 (solver convention, TOA first); aod550
        optionally a per-column field (aod550_field)."""
        psfc = delp.sum(dim=0, keepdim=True)
        shape_prof = torch.exp(-(psfc - p_lay) / self.scale_height_pa)
        wt = shape_prof * delp
        wt = wt / torch.clamp_min(wt.sum(dim=0, keepdim=True), 1e-30)
        aod = self.aod550 if aod550 is None else aod550
        tau550 = aod * wt
        nb = len(self.band_scale)
        bshape = (nb,) + (1,) * tau550.ndim
        opt = dict(dtype=delp.dtype, device=delp.device)
        tau = constant(self.band_scale, **opt).reshape(bshape) * tau550[
            None
        ]
        ssa = constant(self.band_ssa, **opt).reshape(bshape)
        asy = constant(self.band_asy, **opt).reshape(bshape)
        return tau, ssa, asy
