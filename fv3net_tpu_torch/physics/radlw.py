"""Multiband longwave radiative transfer in PyTorch.

Counterpart of the JAX package's ``physics/radlw.py`` (the role of the
reference's ``radlw_main.py`` RadLWClass, 16 bands):

- per-band Planck emission uses exact band fractions of sigma*T^4,
  precomputed at import time in numpy by integrating the Planck function
  over each band's wavenumber limits on a 64-point temperature grid,
  and interpolated linearly (``jnp.interp``'s rule);
- absorption-approximation transfer (no LW scattering, as in RRTMG): the
  JAX package's downward and upward ``lax.scan``s over levels are Python
  loops over levels with all bands and columns batched, diffusivity
  factor 1.66; its ``lax.map`` over g-points is a loop;
- gas optics from radgases.py band coefficients, cloud absorption from
  radclouds.cloud_optics_lw.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import CP_AIR, GRAV
from ..graphs import constant
from . import radclouds, radgases

STEFAN_BOLTZMANN = 5.670374419e-8
DIFFUSIVITY = 1.66

# --- Planck band-fraction tables (computed once at import) ------------
_PLANCK_T_GRID = np.linspace(120.0, 360.0, 64)


def _band_fractions(limits_cm1, t_grid):
    """Fraction of sigma*T^4 emitted in [v1,v2] (cm^-1) at each T."""
    h = 6.62607015e-34
    c = 2.99792458e8
    kb = 1.380649e-23
    fracs = np.zeros((len(limits_cm1), len(t_grid)))
    for i, (v1, v2) in enumerate(limits_cm1):
        v = np.linspace(v1, v2, 256) * 100.0  # -> m^-1
        for j, t in enumerate(t_grid):
            x = h * c * v / (kb * t)
            b = v ** 3 / np.expm1(np.minimum(x, 500.0))
            trapezoid = getattr(np, "trapezoid", None) or np.trapz
            integral = trapezoid(b, v) * (2 * np.pi * h * c * c)
            fracs[i, j] = integral / (STEFAN_BOLTZMANN * t ** 4)
    return fracs


_LW_BAND_FRAC = _band_fractions(radgases.LW_BAND_LIMITS, _PLANCK_T_GRID)


def interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` for increasing xp: linear between the
    points, the end values outside them."""
    i = torch.clamp(
        torch.searchsorted(xp, x.contiguous(), right=True), 1,
        xp.shape[0] - 1,
    )
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    f = fp[i - 1] + (delta / dx) * df
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def planck_band_flux(temp):
    """pi*B integrated over each band: [band, ...temp.shape] W/m^2."""
    opt = dict(dtype=temp.dtype, device=temp.device)
    t_grid = constant(_PLANCK_T_GRID, **opt)
    table = constant(_LW_BAND_FRAC, **opt)
    sig_t4 = STEFAN_BOLTZMANN * temp ** 4
    flat = temp.reshape(-1)
    fracs = torch.stack(
        [interp(flat, t_grid, table[b])
         for b in range(radgases.NBANDS_LW)]
    ).reshape((radgases.NBANDS_LW,) + tuple(temp.shape))
    return fracs * sig_t4[None]


@dataclasses.dataclass
class RadLWClass:
    """LW band solver facade (radlw_main.py:RadLWClass role)."""

    gases: radgases.GasConcentrations = dataclasses.field(
        default_factory=radgases.GasConcentrations
    )

    def optical_depth(self, p_lay, delp, sphum, o3mmr, ql, qi,
                      cldfrac):
        """(tau_gas, tau_cld): the gas part takes the correlated-k
        multipliers; clouds are grey within each band."""
        u_h2o, u_co2, u_o3 = radgases.absorber_paths(
            delp, sphum, o3mmr, self.gases.co2_mass_mixing_ratio()
        )
        nb = radgases.NBANDS_LW
        bshape = (nb,) + (1,) * delp.ndim

        def bc(x):
            return constant(x, delp.dtype, delp.device).reshape(bshape)

        # self-continuum scaling ~ vapor partial pressure
        e_vap = sphum * p_lay / 0.622
        tau = (
            bc(radgases.LW_K_H2O) * u_h2o
            + bc(radgases.LW_K_CO2) * u_co2
            + bc(radgases.LW_K_O3) * u_o3
            + bc(radgases.LW_K_SELF) * u_h2o * (e_vap / 1000.0)
        )
        cwp_l, cwp_i = radclouds.condensate_paths(delp, ql, qi)
        eff = torch.clamp(cldfrac, 0.0, 1.0)
        tau_cld = radclouds.cloud_optics_lw(cwp_l * eff, cwp_i * eff)
        return tau, tau_cld[None]

    def __call__(self, p_lay, delp, temp, sphum, o3mmr, ql, qi,
                 cldfrac, tsfc, sfc_emissivity=0.98):
        """All-sky LW fluxes and heating.

        Column fields [nz, ...cols] (level 0 = model top); tsfc
        [...cols]; sfc_emissivity a number or a [...cols] tensor.
        Returns interface fluxes [nz+1, ...] and the heating rate
        [nz, ...] in K/s.
        """
        tau_gas, tau_cld = self.optical_depth(
            p_lay, delp, sphum, o3mmr, ql, qi, cldfrac
        )
        src = planck_band_flux(temp).movedim(1, 0)  # [nz, band, ...]
        b_sfc = planck_band_flux(tsfc)  # [band, ...]
        zero = torch.zeros_like(src[0])
        nz = src.shape[0]

        fd_g, fu_g = [], []
        for mult in radgases.LW_GPT_MULT:
            # correlated-k quadrature point on the GAS absorption
            tau = tau_gas * float(mult) + tau_cld
            trans = torch.exp(
                -torch.clamp_max(DIFFUSIVITY * tau, 50.0)
            ).movedim(1, 0)
            fdn = [zero]
            for k in range(nz):
                t = trans[k]
                fdn.append(fdn[-1] * t + src[k] * (1.0 - t))
            flux_dn = torch.stack(fdn)  # [nz+1, band, ...]
            fup_sfc = (
                sfc_emissivity * b_sfc
                + (1.0 - sfc_emissivity) * flux_dn[-1]
            )
            fup = [fup_sfc]
            for k in range(nz - 1, -1, -1):
                t = trans[k]
                fup.append(fup[-1] * t + src[k] * (1.0 - t))
            flux_up = torch.stack(fup[::-1])  # [nz+1, band, ...]
            fd_g.append(flux_dn)
            fu_g.append(flux_up)
        fd_g = torch.stack(fd_g)
        fu_g = torch.stack(fu_g)
        w_gpt = constant(
            radgases.LW_GPT_W, delp.dtype, delp.device
        ).reshape((-1,) + (1,) * (fd_g.ndim - 1))
        flux_dn_tot = (w_gpt * fd_g).sum(dim=(0, 2))
        flux_up_tot = (w_gpt * fu_g).sum(dim=(0, 2))
        net = flux_up_tot - flux_dn_tot  # upward positive
        heating = -(net[:-1] - net[1:]) * GRAV / (CP_AIR * delp)
        return {
            "flux_dn": flux_dn_tot,
            "flux_up": flux_up_tot,
            "heating_rate": heating,
            "sfc_dn": flux_dn_tot[-1],
            "sfc_up": flux_up_tot[-1],
            "olr": flux_up_tot[0],
        }
