"""The port's multiband radiation (physics/rad{gases,clouds,surface,sw,lw}.py
and MultibandRadiationDriver, Radiation, RadiationStepper of
physics/radiation.py) against the JAX package's, on the same seeded
inputs in float64 on the CPU.  Tolerance: RTOL of the largest magnitude
of each output (the same operations in the same order; exp/log/pow and
the g-point and band sums may differ by an ulp, and the level
recurrences carry it over nz steps)."""

import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu.physics import radclouds as jclouds
from fv3net_tpu.physics import radgases as jgases
from fv3net_tpu.physics import radiation as jrad
from fv3net_tpu.physics import radlw as jlw
from fv3net_tpu.physics import radsurface as jsurf
from fv3net_tpu.physics import radsw as jsw
from fv3net_tpu.util.quantity import Quantity as JQuantity
from fv3net_tpu_torch.physics import radclouds as tclouds
from fv3net_tpu_torch.physics import radgases as tgases
from fv3net_tpu_torch.physics import radiation as trad
from fv3net_tpu_torch.physics import radlw as tlw
from fv3net_tpu_torch.physics import radsurface as tsurf
from fv3net_tpu_torch.physics import radsw as tsw
from fv3net_tpu_torch.util.quantity import Quantity as TQuantity
from torch_parity import assert_close_scaled

torch.set_num_threads(1)

RTOL = 1e-11
TIME = datetime.datetime(2016, 8, 1, 12)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, name):
    assert_close_scaled(
        got.numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), RTOL, name,
    )


def _column(nz=24, ncol=7, seed=0):
    """Columns, level 0 at the top, with seeded humidity from dry to
    supersaturated (so the RH cloud fraction takes both sides of its
    threshold), some condensate and a warm/cold surface."""
    rng = np.random.RandomState(seed)
    pe = np.linspace(100.0, 101325.0, nz + 1)[:, None] * (
        1.0 + 0.01 * rng.rand(1, ncol)
    )
    delp = pe[1:] - pe[:-1]
    p_lay = 0.5 * (pe[1:] + pe[:-1])
    temp = 288.0 - 55.0 * np.log(101325.0 / p_lay) / np.log(10.0)
    temp = np.clip(temp, 190.0, 320.0) + rng.randn(nz, ncol)
    sphum = 0.012 * (p_lay / 101325.0) ** 3 * (0.3 + rng.rand(nz, ncol))
    sphum = sphum + 1e-6
    ql = np.where(rng.rand(nz, ncol) < 0.4, 2e-4 * rng.rand(nz, ncol), 0.0)
    qi = np.where(rng.rand(nz, ncol) < 0.3, 1e-4 * rng.rand(nz, ncol), 0.0)
    cf = np.clip(rng.rand(nz, ncol) * 1.2 - 0.1, 0.0, 1.0)
    o3 = 1e-6 * (1.0 + rng.rand(nz, ncol))
    return p_lay, delp, temp, sphum, ql, qi, cf, o3


def test_gas_tables_and_ozone():
    for name in ("LW_BAND_LIMITS", "LW_K_H2O", "LW_K_CO2", "LW_K_O3",
                 "LW_K_SELF", "SW_BAND_LIMITS_CM1", "SW_BAND_RANGE_UM",
                 "SW_BAND_UVVIS", "SW_BAND_FRAC", "SW_K_H2O", "SW_K_O3",
                 "SW_K_CO2", "SW_TAU_RAYLEIGH", "SW_GPT_MULT",
                 "SW_GPT_W", "LW_GPT_MULT", "LW_GPT_W"):
        np.testing.assert_array_equal(
            getattr(tgases, name), getattr(jgases, name), err_msg=name
        )
    rng = np.random.RandomState(1)
    p = np.exp(rng.uniform(np.log(50.0), np.log(1.0e5), (6, 12, 5, 5)))
    lat = rng.uniform(-90.0, 90.0, (6, 5, 5))
    for doy in (30.0, 105.0, 200.0, 288.0):
        _close(tgases.ozone_climatology(_t(p), _t(lat), doy),
               jgases.ozone_climatology(jnp.asarray(p), jnp.asarray(lat),
                                        jnp.asarray(doy)), f"o3 {doy}")
    _close(tgases.default_o3_profile(_t(p)),
           jgases.default_o3_profile(jnp.asarray(p)), "default o3")
    for year in (1990.0, 2016.0, 2030.0):
        assert tgases.co2_for_year(year) == jgases.co2_for_year(year)
    gc_t, gc_j = tgases.GasConcentrations(400.0), jgases.GasConcentrations(400.0)
    assert gc_t.co2_mass_mixing_ratio() == gc_j.co2_mass_mixing_ratio()
    p_lay, delp, temp, sphum, *_ , o3 = _column()
    for got, want, name in zip(
        tgases.absorber_paths(_t(delp), _t(sphum), _t(o3), 6e-4),
        jgases.absorber_paths(jnp.asarray(delp), jnp.asarray(sphum),
                              jnp.asarray(o3), 6e-4),
        ("h2o", "co2", "o3"),
    ):
        _close(got, want, name)


def test_clouds_and_aerosols():
    rh = np.linspace(0.5, 1.2, 57)
    cf_t = tclouds.cloud_fraction_from_rh(_t(rh))
    cf_j = jclouds.cloud_fraction_from_rh(jnp.asarray(rh))
    assert float(cf_t.min()) == 0.0 and float(cf_t.max()) == 1.0
    _close(cf_t, cf_j, "cloud fraction")
    p_lay, delp, temp, sphum, ql, qi, cf, o3 = _column()
    # zero and non-zero optical depths (the tau > 0 branch both ways)
    ql[:3] = 0.0
    qi[:3] = 0.0
    wl_t, wi_t = tclouds.condensate_paths(_t(delp), _t(ql), _t(qi))
    wl_j, wi_j = jclouds.condensate_paths(
        jnp.asarray(delp), jnp.asarray(ql), jnp.asarray(qi)
    )
    _close(wl_t, wl_j, "cwp liq")
    for got, want, name in zip(
        tclouds.cloud_optics_sw(wl_t, wi_t),
        jclouds.cloud_optics_sw(wl_j, wi_j), ("tau", "ssa", "asy"),
    ):
        _close(got, want, f"sw {name}")
    _close(tclouds.cloud_optics_lw(wl_t, wi_t),
           jclouds.cloud_optics_lw(wl_j, wi_j), "lw tau")
    aer_t, aer_j = tclouds.AerosolClimatology(), jclouds.AerosolClimatology()
    lat = np.linspace(-80.0, 80.0, delp.shape[1])
    aod_t = aer_t.aod550_field(_t(lat), 150.0)
    aod_j = aer_j.aod550_field(jnp.asarray(lat), jnp.asarray(150.0))
    _close(aod_t, aod_j, "aod550")
    for aod_args in ((None, None), (aod_t, aod_j)):
        for got, want, name in zip(
            aer_t.sw_optics(_t(p_lay), _t(delp), aod550=aod_args[0]),
            aer_j.sw_optics(jnp.asarray(p_lay), jnp.asarray(delp),
                            aod550=aod_args[1]),
            ("tau", "ssa", "asy"),
        ):
            _close(got, want, f"aerosol {name}")


def test_surface_schemes():
    rng = np.random.RandomState(2)
    cosz = np.concatenate([[-0.2, 0.0, 1e-4], rng.rand(40)])
    land = (rng.rand(cosz.size) < 0.5).astype(np.float64)
    snow = rng.uniform(0.0, 20.0, cosz.size)  # below and above saturation
    _close(tsurf.ocean_albedo(_t(cosz)), jsurf.ocean_albedo(jnp.asarray(cosz)),
           "ocean albedo")
    for lm, sn in ((None, 0.0), (land, snow)):
        lt = None if lm is None else _t(lm)
        lj = None if lm is None else jnp.asarray(lm)
        st = sn if np.isscalar(sn) else _t(sn)
        sj = sn if np.isscalar(sn) else jnp.asarray(sn)
        _close(tsurf.surface_albedo(_t(cosz), lt, st),
               jsurf.surface_albedo(jnp.asarray(cosz), lj, sj), "albedo")
        got = tsurf.surface_albedo_spectral(_t(cosz), lt, st)
        want = jsurf.surface_albedo_spectral(jnp.asarray(cosz), lj, sj)
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], f"spectral {k}")
        if lm is not None:
            _close(tsurf.surface_emissivity(lt, st),
                   jsurf.surface_emissivity(lj, sj), "emissivity")
    assert float(tsurf.surface_emissivity(None, 0.0)) == float(
        jsurf.surface_emissivity(None, 0.0)
    )


@pytest.mark.parametrize("spectral", [False, True])
def test_sw_solver(spectral):
    p_lay, delp, temp, sphum, ql, qi, cf, o3 = _column()
    ncol = delp.shape[1]
    mu0 = np.array([1.0, 0.7, 0.4, 0.15, 0.02, 0.0, -0.3])[:ncol]
    if spectral:
        land = np.array([0.0, 1.0, 1.0, 0.0, 1.0, 0.0, 1.0])[:ncol]
        snow = np.array([0.0, 2.0, 30.0, 0.0, 5.0, 0.0, 0.0])[:ncol]
        alb_t = tsurf.surface_albedo_spectral(_t(mu0), _t(land), _t(snow))
        alb_j = jsurf.surface_albedo_spectral(
            jnp.asarray(mu0), jnp.asarray(land), jnp.asarray(snow)
        )
    else:
        alb_t, alb_j = _t(np.full(ncol, 0.15)), jnp.full(ncol, 0.15)
    aod = np.linspace(0.05, 0.3, ncol)
    args = (p_lay, delp, sphum, o3, ql, qi, cf)
    got = tsw.RadSWClass()(
        _t(mu0), *map(_t, args), alb_t, 1360.0, aod550=_t(aod)
    )
    want = jsw.RadSWClass()(
        jnp.asarray(mu0), *map(jnp.asarray, args), alb_j, 1360.0,
        aod550=jnp.asarray(aod),
    )
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], f"sw {k}")
    assert float(got["flux_dn"][:, -2:].abs().max()) == 0.0  # night


def test_lw_solver():
    p_lay, delp, temp, sphum, ql, qi, cf, o3 = _column()
    ncol = delp.shape[1]
    # temperatures outside the Planck table's 120-360 K range too
    temp[0, 0], temp[1, 1] = 100.0, 380.0
    tsfc = np.linspace(260.0, 310.0, ncol)
    emis = np.linspace(0.9, 1.0, ncol)
    args = (p_lay, delp, temp, sphum, o3, ql, qi, cf)
    for e_t, e_j in ((0.98, 0.98), (_t(emis), jnp.asarray(emis))):
        got = tlw.RadLWClass()(*map(_t, args), _t(tsfc), sfc_emissivity=e_t)
        want = jlw.RadLWClass()(*map(jnp.asarray, args), jnp.asarray(tsfc),
                                sfc_emissivity=e_j)
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], f"lw {k}")
    _close(tlw.planck_band_flux(_t(temp)),
           jlw.planck_band_flux(jnp.asarray(temp)), "planck")


def _cube(n, nz, seed=3):
    """A seeded C`n` state [6, nz, n, n] with land and snow fields."""
    rng = np.random.RandomState(seed)
    pe = np.linspace(100.0, 101325.0, nz + 1)
    pe = pe[None, :, None, None] * (1.0 + 0.01 * rng.rand(6, 1, n, n))
    delp = pe[:, 1:] - pe[:, :-1]
    p_lay = 0.5 * (pe[:, 1:] + pe[:, :-1])
    temp = 288.0 - 60.0 * (1.0 - p_lay / 101325.0) + rng.randn(6, nz, n, n)
    sphum = 0.012 * (p_lay / 101325.0) ** 3 * (0.4 + 0.9 * rng.rand(6, nz, n, n))
    ql = np.where(rng.rand(6, nz, n, n) < 0.3, 1e-4, 0.0)
    qi = np.where(rng.rand(6, nz, n, n) < 0.2, 5e-5, 0.0)
    tsfc = 285.0 + 10.0 * rng.rand(6, n, n)
    land = (rng.rand(6, n, n) < 0.4).astype(np.float64)
    snow = np.where(rng.rand(6, n, n) < 0.5, 20.0 * rng.rand(6, n, n), 0.0)
    lat = rng.uniform(-85.0, 85.0, (6, n, n))
    lon = rng.uniform(0.0, 360.0, (6, n, n))
    return dict(p_lay=p_lay, delp=delp, temp=temp, sphum=sphum, ql=ql,
                qi=qi, tsfc=tsfc, land_mask=land, snow=snow, lat=lat,
                lon=lon)


@pytest.mark.parametrize("albedo", [None, 0.12])
def test_multiband_driver_full_cube(albedo):
    c = _cube(6, 10)
    jd = jrad.MultibandRadiationDriver(albedo=albedo)
    td = trad.MultibandRadiationDriver(albedo=albedo)
    jd.radupdate(TIME)
    td.radupdate(TIME)
    assert td._solcon == pytest.approx(float(jd._solcon), rel=1e-15)
    fields = ("p_lay", "delp", "temp", "sphum", "tsfc")
    want = jd.gfs_radiation_driver(
        TIME, c["lon"], c["lat"], *(c[k] for k in fields),
        ql=c["ql"], qi=c["qi"], land_mask=c["land_mask"], snow=c["snow"],
    )
    got = td.gfs_radiation_driver(
        TIME, c["lon"], c["lat"], *(_t(c[k]) for k in fields),
        ql=_t(c["ql"]), qi=_t(c["qi"]), land_mask=_t(c["land_mask"]),
        snow=_t(c["snow"]),
    )
    assert set(got) == set(want)
    for k in want:
        assert isinstance(got[k], torch.Tensor) and got[k].device.type == "cpu"
        _close(got[k], want[k], k)
    day = got["total_sky_downward_shortwave_flux_at_top_of_atmosphere"]
    assert float(day.max()) > 600.0 and float(day.min()) == 0.0


def test_radiation_facade_and_stepper_on_a_wrapper_state():
    from fv3net_tpu.physics import radiation as jr
    from fv3net_tpu_torch.runtime import names

    c = _cube(6, 10, seed=4)
    arrays = {
        names.DELP: (c["delp"], ("tile", "z", "y", "x")),
        names.TEMP: (c["temp"], ("tile", "z", "y", "x")),
        names.SPHUM: (c["sphum"], ("tile", "z", "y", "x")),
        names.TSFC: (c["tsfc"], ("tile", "y", "x")),
        "latitude": (np.deg2rad(c["lat"]), ("tile", "y", "x")),
        "longitude": (np.deg2rad(c["lon"]), ("tile", "y", "x")),
    }
    jstate = {k: JQuantity(jnp.asarray(a), d) for k, (a, d) in arrays.items()}
    tstate = {k: TQuantity(_t(a), d) for k, (a, d) in arrays.items()}
    jstep = jr.RadiationStepper(
        jr.Radiation(jr.MultibandRadiationDriver()), 900.0
    )
    tstep = trad.RadiationStepper(
        trad.Radiation(trad.MultibandRadiationDriver()), 900.0
    )
    for minutes in (0, 30):  # the second call is inside fhswr: no update
        t = TIME + datetime.timedelta(minutes=minutes)
        jt, jdiag, _ = jstep(t, jstate)
        tt, tdiag, _ = tstep(t, tstate)
        _close(tt["dQ1"].data, jt["dQ1"].data, "dQ1")
        assert tt["dQ1"].dims == jt["dQ1"].dims
        assert set(tdiag) == set(jdiag)
        for k in jdiag:
            assert tdiag[k].dims == jdiag[k].dims
            assert tdiag[k].units == jdiag[k].units
            _close(tdiag[k].data, jdiag[k].data, k)
    assert tstep.radiation._last_update == TIME
    _, q = tstep.get_diagnostics(tstate, None)
    assert q.dims == ()
    # the facade drives the gray driver too (the same contract)
    gray_t = trad.Radiation()(TIME, tstate)
    gray_j = jr.Radiation()(TIME, jstate)
    for k in gray_j:
        _close(gray_t[k], gray_j[k], f"gray {k}")
