"""Gray radiation driver (the JAX package's ``physics/radiation.py``,
lines 29-130: ``GFSPhysicsControl`` and ``RadiationDriver``).

One shortwave band with zenith-angle geometry and one longwave band with
a water-vapour-weighted emissivity: physically shaped heating rates and
surface fluxes for the coupled step.  The astronomy (solar constant,
cos zenith) is host numpy; ``_core`` is tensor code on the state's
device, jitted as the JAX package's ``_jit_core`` (``graphs.jit``: one
replayed graph on the card, cos zenith and the solar constant entering
as tensors).

Also the JAX file's ``MultibandRadiationDriver`` (lines 133-257: the
delta-Eddington SW and band-absorption LW of radsw.py/radlw.py with the
gas, cloud, aerosol and surface schemes) and the ``Radiation`` and
``RadiationStepper`` facades (lines 259-329), which nothing calls in
either package: the coupled step and the wrapper run the gray driver.
Unlike the JAX multiband driver, which returns host numpy, every driver
here returns tensors on the state's device.  Its ``_compute`` is jitted
too (the JAX package's ``_jit``), the day of year and the solar constant
entering as float64 0-d tensors.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Mapping

import numpy as np
import torch

from ..constants import CP_AIR, GRAV
from ..device import device_for
from ..graphs import jit
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
        # one dispatch a call (the JAX package's self._jit_core)
        self._jit_core = jit(self._core)

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
        opt = dict(dtype=temp.dtype, device=temp.device)
        # the solar constant is rounded to float32 here whatever the
        # state's dtype, as the JAX package's driver does; it and cos
        # zenith change between calls, so both enter as tensors
        return self._jit_core(
            torch.as_tensor(cosz, **opt), p_lay, delp, temp, sphum, tsfc,
            torch.full((), float(np.float32(self._solcon)), **opt),
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


class MultibandRadiationDriver:
    """Multiband RRTMG-role driver (radiation_driver.py:18): SW
    delta-Eddington two-stream + adding (radsw.py), LW band absorption
    (radlw.py), cloud/aerosol/gas optics (radclouds/radgases), batched
    over [band, nz, columns] tensors.

    Same call contract as the gray ``RadiationDriver``, so the
    ``Radiation`` facade and ``RadiationStepper`` drive either scheme.
    """

    def __init__(self, albedo: float = None, co2_ppmv: float = 420.0):
        from . import radlw, radsw
        from .radgases import GasConcentrations, ozone_climatology

        # albedo=None (default): the zenith/type/snow-dependent scheme
        # (radsurface.surface_albedo_spectral, the setalb role); a float
        # pins a constant albedo
        self.albedo = albedo
        gases = GasConcentrations(co2_ppmv=co2_ppmv)
        self._sw = radsw.RadSWClass(gases=gases)
        self._lw = radlw.RadLWClass(gases=gases)
        self._o3 = ozone_climatology
        self._solcon = SOLAR_CONSTANT
        self._doy = 1.0
        # one dispatch a call (the JAX package's self._jit)
        self._jit = jit(self._compute)

    def radupdate(self, time: datetime.datetime):
        """(radiation_driver.py:209): annual solar-constant cycle and
        the climatologies' seasonal phase (float64 host arithmetic)."""
        doy = time.timetuple().tm_yday
        self._doy = float(doy)
        self._solcon = SOLAR_CONSTANT * (
            1.0 + 0.034 * math.cos(2 * math.pi * (doy - 3) / 365.25)
        )

    def _compute(self, cosz, p_lay, delp, temp, sphum, ql, qi, tsfc,
                 solcon, lat_deg, doy, land_mask, snow):
        from ..utils.thermo import relative_humidity_from_pressure
        from .radclouds import cloud_fraction_from_rh
        from .radsurface import surface_albedo_spectral, surface_emissivity

        o3 = self._o3(p_lay, lat_deg, doy)
        rh = relative_humidity_from_pressure(temp, sphum, p_lay)
        cf = cloud_fraction_from_rh(rh)

        def cols(x):  # [6, nz, n, n] -> [nz, 6, n, n]
            return x.movedim(1, 0)

        if self.albedo is None:
            # spectral direct/diffuse x UV-VIS/NIR components (setalb
            # contract); radsw selects the window per band
            alb = surface_albedo_spectral(
                torch.clamp_min(cosz, 0.0), land_mask, snow
            )
            emis = surface_emissivity(land_mask, snow)
        else:
            alb = torch.full_like(tsfc, self.albedo)
            emis = 0.98
        aod = self._sw.aerosols.aod550_field(lat_deg, doy)
        sw = self._sw(
            torch.clamp_min(cosz, 0.0), cols(p_lay), cols(delp),
            cols(sphum), cols(o3), cols(ql), cols(qi), cols(cf),
            alb, solcon, aod550=aod,
        )
        lw = self._lw(
            cols(p_lay), cols(delp), cols(temp), cols(sphum),
            cols(o3), cols(ql), cols(qi), cols(cf), tsfc,
            sfc_emissivity=emis,
        )

        def rows(x):  # [nz(+1), 6, n, n] -> [6, nz(+1), n, n]
            return x.movedim(0, 1)

        return {
            "total_sky_downward_shortwave_flux_at_surface":
                sw["sfc_dn"],
            "total_sky_net_shortwave_flux_at_surface": sw["sfc_net"],
            "total_sky_downward_longwave_flux_at_surface":
                lw["sfc_dn"],
            "total_sky_upward_longwave_flux_at_surface": lw["sfc_up"],
            "shortwave_heating_rate": rows(sw["heating_rate"]),
            "longwave_heating_rate": rows(lw["heating_rate"]),
            "total_sky_downward_shortwave_flux_at_top_of_atmosphere":
                sw["toa_dn"],
            "total_sky_upward_shortwave_flux_at_top_of_atmosphere":
                sw["toa_up"],
            "total_sky_upward_longwave_flux_at_top_of_atmosphere":
                lw["olr"],
        }

    def gfs_radiation_driver(
        self, time, lon_deg, lat_deg, p_lay, delp, temp, sphum, tsfc,
        ql=None, qi=None, land_mask=None, snow=None, device=None,
    ) -> Mapping[str, torch.Tensor]:
        """(radiation_driver.py:354).  Fields [6, nz, n, n]; lon/lat
        (degrees, host arrays) and tsfc [6, n, n]; ql/qi optional
        condensate mixing ratios; land_mask (1 = land) and snow (kg/m^2
        SWE) feed the surface albedo/emissivity scheme (radsurface).
        Tensors stay on their device and the outputs are tensors there;
        host arrays go to `device` (the CUDA device unless the caller
        names one)."""
        dev = device_for(
            (temp, delp, p_lay, sphum, tsfc), device,
            "MultibandRadiationDriver.gfs_radiation_driver",
        )

        def t(x, like=None):
            if x is None:
                return torch.zeros_like(like)
            return torch.as_tensor(x, device=dev)

        temp = t(temp)
        p_lay, delp, sphum, tsfc = (t(x) for x in (p_lay, delp, sphum, tsfc))
        ql, qi = t(ql, sphum), t(qi, sphum)
        land_mask, snow = t(land_mask, tsfc), t(snow, tsfc)
        lon = np.asarray(torch.as_tensor(lon_deg).cpu())
        lat = np.asarray(torch.as_tensor(lat_deg).cpu())
        cosz = np.maximum(cos_zenith_angle(time, lon, lat), 0.0)
        opt = dict(dtype=temp.dtype, device=dev)
        # the solar constant and the day of year change between calls:
        # float64 0-d tensors, the host's float64 arithmetic on the device
        f64 = dict(dtype=torch.float64, device=dev)
        return self._jit(
            torch.as_tensor(cosz, **opt), p_lay, delp, temp, sphum, ql,
            qi, tsfc, torch.full((), self._solcon, **f64),
            torch.as_tensor(lat, **opt), torch.full((), self._doy, **f64),
            land_mask, snow,
        )


class Radiation:
    """Facade wiring a driver to wrapper state names
    (wrapper_api.py:119).  Reads the state's tensors where they are (a
    Quantity holding a host array goes to `device`, the CUDA device
    unless the caller names one)."""

    def __init__(self, driver: RadiationDriver = None,
                 control: GFSPhysicsControl = None, device=None):
        self.driver = driver or RadiationDriver()
        self.control = control or GFSPhysicsControl()
        self.device = device
        self._last_update = None

    def __call__(self, time, state) -> Mapping[str, torch.Tensor]:
        from ..runtime import names
        from ..utils.thermo import pressure_at_midpoint_log

        if (
            self._last_update is None
            or (time - self._last_update).total_seconds()
            >= self.control.fhswr
        ):
            self.driver.radupdate(time)
            self._last_update = time
        fields = [state[k].data for k in (
            names.DELP, names.TEMP, names.SPHUM, names.TSFC
        )]
        dev = device_for(fields, self.device, "Radiation")
        delp, temp, sphum, tsfc = (
            torch.as_tensor(x, device=dev) for x in fields
        )
        lat = np.rad2deg(state["latitude"].values)
        lon = np.rad2deg(state["longitude"].values)
        p_lay = pressure_at_midpoint_log(delp, axis=1)
        return self.driver.gfs_radiation_driver(
            time, lon, lat, p_lay, delp, temp, sphum, tsfc
        )


class RadiationStepper:
    """Stepper applying radiative heating to the model state
    (runtime/steppers/radiation.py:27)."""

    label = "radiation"

    def __init__(self, radiation: Radiation, dt: float):
        self.radiation = radiation
        self.dt = dt

    def __call__(self, time, state):
        from ..util.quantity import Quantity

        out = self.radiation(time, state)
        heating = (
            out["shortwave_heating_rate"]
            + out["longwave_heating_rate"]
        )
        diags = {
            k: Quantity(
                v,
                ("tile", "z", "y", "x") if v.ndim == 4
                else ("tile", "y", "x"),
                "W/m**2" if "flux" in k else "K/s",
            )
            for k, v in out.items()
        }
        tendencies = {
            "dQ1": Quantity(heating, ("tile", "z", "y", "x"), "K/s")
        }
        return tendencies, diags, {}

    def get_diagnostics(self, state, tendency):
        from ..util.quantity import Quantity

        return {}, Quantity(np.zeros(()), (), "")
