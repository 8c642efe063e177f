"""Multiband shortwave radiative transfer in PyTorch.

Counterpart of the JAX package's ``physics/radsw.py`` (the role of the
reference's ``radsw_main.py`` RadSWClass, 14 bands):

- optical properties are [band, nz, ...column] tensors built by
  elementwise expressions (radgases/radclouds);
- each layer gets delta-Eddington-scaled two-stream reflectance and
  transmittance (direct + diffuse), then the layers are combined with
  the adding method: the JAX package's two ``lax.scan``s over levels are
  two Python loops over levels here, each step one elementwise block
  over [band, columns];
- each band carries a small correlated-k quadrature
  (radgases.SW_GPT_*): gas optical depth is evaluated at NGPT_SW
  multipliers per band, one after another (the JAX package's
  ``lax.map``), and the fluxes are g-weight-summed;
- spectral surface albedo: direct/diffuse x UV-VIS/NIR components
  (radsurface.surface_albedo_spectral) selected per band.
"""

from __future__ import annotations

import dataclasses

import torch

from ..constants import CP_AIR, GRAV
from ..graphs import constant
from . import radclouds, radgases

SOLAR_CONSTANT = 1361.0


def delta_scale(tau, w, g):
    """Delta-Eddington scaling: fold the forward-scattering peak f=g^2
    into the direct beam (Joseph, Wiscombe & Weinman 1976)."""
    f = g * g
    tau_s = (1.0 - w * f) * tau
    w_s = (1.0 - f) * w / torch.clamp_min(1.0 - w * f, 1e-12)
    g_s = (g - f) / torch.clamp_min(1.0 - f, 1e-12)
    return tau_s, w_s, g_s


def two_stream_layer(tau, w, g, mu0):
    """Two-stream (Eddington) layer reflectance/transmittance.

    Returns (rdif, tdif, rdir, tdir_dif, tdir_dir):
      rdif/tdif   -- reflect/transmit for diffuse incidence
                     (Meador & Weaver 1980 Eddington coefficients);
      rdir        -- upward diffuse from unit direct incidence;
      tdir_dif    -- downward diffuse exiting the layer bottom from
                     unit direct incidence;
      tdir_dir    -- surviving direct beam exp(-tau/mu0).

    The direct-beam source uses the energy-conserving single-scatter
    split: of the scattered fraction w*(1-t0), g3 goes up and g4 down
    (multiple scattering between layers is recovered by the adding
    method), so rdir + tdir_dif + absorbed + tdir_dir == 1 exactly.
    """
    w = torch.clamp(w, 1e-6, 1.0 - 1e-6)
    g1 = 0.25 * (7.0 - w * (4.0 + 3.0 * g))
    g2 = -0.25 * (1.0 - w * (4.0 - 3.0 * g))
    g3 = 0.25 * (2.0 - 3.0 * g * mu0)
    g4 = 1.0 - g3
    lam = torch.sqrt(torch.clamp_min(g1 * g1 - g2 * g2, 1e-12))
    e = torch.exp(-torch.clamp_max(lam * tau, 50.0))
    e2 = e * e
    denom = lam + g1 + (lam - g1) * e2
    rdif = g2 * (1.0 - e2) / denom
    tdif = 2.0 * lam * e / denom

    mu0 = torch.clamp_min(mu0, 1e-3)
    t0 = torch.exp(-torch.clamp_max(tau / mu0, 50.0))
    scat = w * (1.0 - t0)
    rdir = scat * g3
    tdir_dif = scat * g4
    return rdif, tdif, rdir, tdir_dif, t0


def adding_method(rdif, tdif, rdir, tdir_dif, tdir_dir, alb_dir,
                  alb_dif, mu0, toa_flux):
    """Combine layers with the adding method; fluxes at all interfaces.

    Layer tensors are [nz, ...cols]; alb_*/toa_flux are [...cols] (any
    leading batch axes, e.g. bands, go into cols).  Returns (flux_dn,
    flux_up) at [nz+1, ...] interfaces, in units of toa_flux
    (normal-incidence irradiance x mu0 applied here).

    Pass 1 (surface up): stack albedo below each interface for diffuse
    (a_dif) and direct (a_dir) incidence:
        a_dir' = rdir + tdif*(t0*a_dir + tdir_dif*a_dif)/(1-rdif*a_dif)
        a_dif' = rdif + tdif^2*a_dif/(1-rdif*a_dif)
    Pass 2 (TOA down): propagate (diffuse-down, direct) through each
    layer with interreflection against the stack below.
    """
    nz = rdif.shape[0]
    a_dif, a_dir = alb_dif, alb_dir
    adif_b = [None] * nz  # albedo of the stack below layer k
    adir_b = [None] * nz
    for k in range(nz - 1, -1, -1):
        adif_b[k], adir_b[k] = a_dif, a_dir
        rd, td = rdif[k], tdif[k]
        denom = 1.0 / torch.clamp_min(1.0 - rd * a_dif, 1e-12)
        new_adir = rdir[k] + td * denom * (
            tdir_dir[k] * a_dir + tdir_dif[k] * a_dif
        )
        new_adif = rd + td * td * a_dif * denom
        a_dif, a_dir = new_adif, new_adir
    a_dir_top = a_dir

    zero = torch.zeros_like(toa_flux)
    fdn_dif, fdir = zero, toa_flux
    dn_dif, dirs, ups = [zero], [toa_flux], [toa_flux * a_dir_top]
    for k in range(nz):
        rd, td = rdif[k], tdif[k]
        ab_dif, ab_dir = adif_b[k], adir_b[k]
        denom = 1.0 / torch.clamp_min(1.0 - rd * ab_dif, 1e-12)
        new_fdir = fdir * tdir_dir[k]
        src = fdir * tdir_dif[k] + fdn_dif * td
        new_fdn = (src + new_fdir * ab_dir * rd) * denom
        fup = new_fdir * ab_dir + new_fdn * ab_dif
        fdn_dif, fdir = new_fdn, new_fdir
        dn_dif.append(new_fdn)
        dirs.append(new_fdir)
        ups.append(fup)
    flux_dn = (torch.stack(dn_dif) + torch.stack(dirs)) * mu0[None]
    return flux_dn, torch.stack(ups) * mu0[None]


def _table(a, like, shape):
    return constant(a, like.dtype, like.device).reshape(shape)


@dataclasses.dataclass
class RadSWClass:
    """SW band solver facade (radsw_main.py:RadSWClass role)."""

    aerosols: radclouds.AerosolClimatology = dataclasses.field(
        default_factory=radclouds.AerosolClimatology
    )
    gases: radgases.GasConcentrations = dataclasses.field(
        default_factory=radgases.GasConcentrations
    )

    def __call__(self, mu0, p_lay, delp, sphum, o3mmr, ql, qi, cldfrac,
                 sfc_albedo, solcon=SOLAR_CONSTANT, aod550=None):
        """All-sky SW fluxes and heating.

        Shapes: column fields [nz, ...cols]; mu0 [...cols]; sfc_albedo a
        tensor [...cols] (broadband) or a dict of the four spectral
        components (surface_albedo_spectral).  Returns a dict of
        interface fluxes ([nz+1, ...]) and the heating rate (K/s,
        [nz, ...]).
        """
        u_h2o, u_co2, u_o3 = radgases.absorber_paths(
            delp, sphum, o3mmr, self.gases.co2_mass_mixing_ratio()
        )
        nb = radgases.NBANDS_SW
        bshape = (nb,) + (1,) * delp.ndim

        def bc(x):
            return _table(x, delp, bshape)

        tau_gas = (
            bc(radgases.SW_K_H2O) * u_h2o
            + bc(radgases.SW_K_O3) * u_o3
            + bc(radgases.SW_K_CO2) * u_co2
        )
        tau_ray = bc(radgases.SW_TAU_RAYLEIGH) * (delp / 101325.0)
        tau_aer, w_aer, g_aer = self.aerosols.sw_optics(
            p_lay, delp, aod550=aod550
        )
        cwp_l, cwp_i = radclouds.condensate_paths(delp, ql, qi)
        # effective (random-overlap) cloud optics: tau scaled by
        # cldfrac^(3/2), the standard effective-optical-depth closure
        eff = torch.clamp(cldfrac, 0.0, 1.0) ** 1.5
        tau_c, w_c, g_c = radclouds.cloud_optics_sw(
            cwp_l * eff, cwp_i * eff
        )
        # grey (g-point-independent) scattering components
        tau_grey = tau_ray + tau_aer + tau_c[None]
        wtau = tau_ray + tau_aer * w_aer + (w_c * tau_c)[None]
        gwtau = tau_aer * w_aer * g_aer + (g_c * w_c * tau_c)[None]
        g_eff = gwtau / torch.clamp_min(wtau, 1e-12)

        mu0c = torch.clamp_min(mu0, 1e-3)
        cshape = (nb,) + (1,) * (delp.ndim - 1)
        toa = solcon * _table(radgases.SW_BAND_FRAC, delp, cshape) * (
            torch.ones_like(mu0c)[None]
        )
        # spectral surface albedo: a dict selects the UV-VIS vs NIR
        # component per band (setalb contract); a tensor is the legacy
        # broadband form
        uvvis = constant(
            radgases.SW_BAND_UVVIS, None, delp.device
        ).reshape(cshape)
        if isinstance(sfc_albedo, dict):
            alb_dir = torch.where(
                uvvis, sfc_albedo["uvvis_dir"][None],
                sfc_albedo["nir_dir"][None],
            ) * torch.ones_like(toa)
            alb_dif = torch.where(
                uvvis, sfc_albedo["uvvis_dif"][None],
                sfc_albedo["nir_dif"][None],
            ) * torch.ones_like(toa)
        else:
            alb_dir = torch.broadcast_to(sfc_albedo, toa.shape)
            alb_dif = alb_dir

        fd_g, fu_g = [], []
        # one quadrature point after another (the JAX package's lax.map)
        for mult in radgases.SW_GPT_MULT:
            # correlated-k quadrature point: scale the GAS absorption
            tau_g = tau_gas * float(mult) + tau_grey
            w_g = torch.clamp(
                wtau / torch.clamp_min(tau_g, 1e-12), 0.0, 1.0 - 1e-6
            )
            tau_s, w_s, g_s = delta_scale(tau_g, w_g, g_eff)
            layers = two_stream_layer(tau_s, w_s, g_s, mu0c)
            # every band at once: [band, nz, ...] -> [nz, band, ...]
            fd, fu = adding_method(
                *(x.movedim(1, 0) for x in layers), alb_dir, alb_dif,
                mu0c, toa,
            )
            fd_g.append(fd.movedim(0, 1))
            fu_g.append(fu.movedim(0, 1))
        fd_g = torch.stack(fd_g)  # [g, band, nz+1, ...]
        fu_g = torch.stack(fu_g)
        w_gpt = _table(
            radgases.SW_GPT_W, delp, (-1,) + (1,) * (fd_g.ndim - 1)
        )
        flux_dn = (w_gpt * fd_g).sum(dim=(0, 1))
        flux_up = (w_gpt * fu_g).sum(dim=(0, 1))
        day = (mu0 > 1e-3).to(flux_dn.dtype)
        flux_dn = flux_dn * day[None]
        flux_up = flux_up * day[None]
        net = flux_dn - flux_up
        heating = (net[:-1] - net[1:]) * GRAV / (CP_AIR * delp)
        return {
            "flux_dn": flux_dn,
            "flux_up": flux_up,
            "heating_rate": heating,
            "sfc_dn": flux_dn[-1],
            "sfc_net": net[-1],
            "toa_dn": flux_dn[0],
            "toa_up": flux_up[0],
        }
