"""Gray radiation driver (the JAX package's ``physics/radiation.py``,
lines 29-130: ``GFSPhysicsControl`` and ``RadiationDriver``).

One shortwave band with zenith-angle geometry and one longwave band with
a water-vapour-weighted emissivity: physically shaped heating rates and
surface fluxes for the coupled step.  The astronomy (solar constant,
cos zenith) is host numpy; ``_core`` is tensor code on the state's
device.  The multiband driver and the ``Radiation``/``RadiationStepper``
facades, which nothing on the coupled path calls, are not ported
(ROADMAP).
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Mapping

import numpy as np
import torch

from ..constants import CP_AIR, GRAV
from ..utils.zenith import cos_zenith_angle
from .gfs import _rev_cumsum

SOLAR_CONSTANT = 1361.0  # W/m^2
STEFAN_BOLTZMANN = 5.670374e-8


@dataclasses.dataclass
class GFSPhysicsControl:
    """(wrapper_api.py:40): radiation cadence control."""

    fhswr: float = 3600.0  # SW call interval (s)
    fhlwr: float = 3600.0
    nsswr: int = 4
    nslwr: int = 4


class RadiationDriver:
    """(radiation_driver.py:18): holds slowly varying inputs, exposes
    radupdate and the per-step driver call."""

    def __init__(self, sw_tau0: float = 0.2, lw_tau0: float = 4.0,
                 albedo: float = 0.12):
        self.sw_tau0 = sw_tau0
        self.lw_tau0 = lw_tau0
        self.albedo = albedo
        self._solcon = SOLAR_CONSTANT

    def radupdate(self, time: datetime.datetime):
        """(radiation_driver.py:209): annual cycle of the earth-sun
        distance (+/- 3.4%) in the solar constant."""
        doy = time.timetuple().tm_yday
        self._solcon = SOLAR_CONSTANT * (
            1.0 + 0.034 * math.cos(2 * math.pi * (doy - 3) / 365.25)
        )

    def gfs_radiation_driver(
        self, time, lon_deg, lat_deg, p_lay, delp, temp, sphum, tsfc
    ) -> Mapping[str, torch.Tensor]:
        """(radiation_driver.py:354): SW/LW heating rates and
        surface/TOA fluxes.  Fields [6, nz, n, n] except lon/lat (numpy,
        degrees) and tsfc [6, n, n]."""
        cosz = np.maximum(cos_zenith_angle(time, lon_deg, lat_deg), 0.0)
        # the solar constant is rounded to float32 here whatever the
        # state's dtype, as the JAX package's driver does
        return self._core(
            torch.as_tensor(cosz, dtype=temp.dtype, device=temp.device),
            p_lay, delp, temp, sphum, tsfc, float(np.float32(self._solcon)),
        )

    def _core(self, cosz, p_lay, delp, temp, sphum, tsfc, solcon):
        # --- shortwave: gray absorption along the slant path ----------
        colmass = delp.sum(dim=1, keepdim=True)
        dtau = self.sw_tau0 * (delp / colmass) * (1.0 + 20.0 * sphum)
        slant = 1.0 / torch.clamp_min(cosz, 0.05)[:, None]
        trans = torch.exp(-torch.cumsum(dtau, dim=1) * slant)
        toa_down = solcon * cosz
        flux_dn = toa_down[:, None] * torch.cat(
            [torch.ones_like(trans[:, :1]), trans], dim=1
        )  # [6, nz+1, n, n]
        sfc_down = flux_dn[:, -1]
        absorbed = flux_dn[:, :-1] - flux_dn[:, 1:]
        sw_heating = GRAV * absorbed / (CP_AIR * delp)  # K/s
        sfc_net_sw = sfc_down * (1.0 - self.albedo)

        # --- longwave: emissivity-weighted exchange with surface ------
        dtau_lw = self.lw_tau0 * (delp / colmass) * (1.0 + 50.0 * sphum)
        eps = 1.0 - torch.exp(-dtau_lw)
        sigma_t4 = STEFAN_BOLTZMANN * temp ** 4
        # downward LW at surface: layer emissions attenuated below them
        below = _rev_cumsum(dtau_lw) - dtau_lw
        sfc_down_lw = (eps * sigma_t4 * torch.exp(-below)).sum(dim=1)
        up_sfc = STEFAN_BOLTZMANN * tsfc ** 4
        # cooling-to-space approximation for heating rates
        above = torch.cumsum(dtau_lw, dim=1) - dtau_lw
        lw_cooling = (
            -GRAV * eps * sigma_t4 * torch.exp(-above) / (CP_AIR * delp)
        )
        return {
            "total_sky_downward_shortwave_flux_at_surface": sfc_down,
            "total_sky_net_shortwave_flux_at_surface": sfc_net_sw,
            "total_sky_downward_longwave_flux_at_surface": sfc_down_lw,
            "total_sky_upward_longwave_flux_at_surface": up_sfc,
            "shortwave_heating_rate": sw_heating,
            "longwave_heating_rate": lw_cooling,
            "total_sky_downward_shortwave_flux_at_top_of_atmosphere":
                toa_down,
        }
