"""The nudged run's physics in fv3net_tpu_torch against the JAX package:
the GFDL 6-category microphysics (``physics/gfdl_mp.py``), the SAS-style
mass-flux convection (``physics/convection.py``), the orographic
gravity-wave drag (``physics/gwd.py``), the Noah-style land model
(``physics/land.py``) and ``gfs_physics_step`` with GFDL and prognostic
hydrometeors, with the mass flux and with the drag; float64 on the CPU,
the same seeded numpy inputs through both packages.  Then the closures of
tests/test_gfdl_mp.py, tests/test_land_convection.py and
tests/test_gwd_shalconv.py, run on the port."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu.physics import convection as jconv
from fv3net_tpu.physics import gfdl_mp as jmp
from fv3net_tpu.physics import gfs as jgfs
from fv3net_tpu.physics import gwd as jgwd
from fv3net_tpu.physics import land as jland
from fv3net_tpu_torch.constants import (
    CP_AIR,
    GRAV,
    LATENT_HEAT_FUSION as LF,
    LATENT_HEAT_VAPORIZATION as LV,
)
from fv3net_tpu_torch.physics import convection as tconv
from fv3net_tpu_torch.physics import gfdl_mp as tmp
from fv3net_tpu_torch.physics import gfs as tgfs
from fv3net_tpu_torch.physics import gwd as tgwd
from fv3net_tpu_torch.physics import land as tland
from torch_parity import assert_close_scaled

torch.set_num_threads(1)

# float64 in both packages: the same operations in the same order, so
# every output agrees to roundoff; a column on another branch of a
# threshold (the SAS trigger, a clip, the mixed-phase ramp) would differ
# by O(1) of the field, far above 1e-9 of its magnitude
RTOL = 1e-9


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def _j(x):
    return jnp.asarray(np.asarray(x, np.float64))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _close_dicts(got, want, tag):
    assert set(got) == set(want), (tag, sorted(got), sorted(want))
    for k, w in want.items():
        assert_close_scaled(_np(got[k]), _np(w), RTOL, name=f"{tag} {k}")


# --- seeded inputs (the JAX package's test fixtures, in float64) ------------


def _column_state(seed=0, nz=20, n=3, moist=True):
    """t, qv, ql, qi, qr, qs, qg, p, delp, dz [6, nz, n, n]: 50 -> 1000
    hPa, cloud liquid below 400 hPa and ice below 260 K, as
    tests/test_gfdl_mp.py; rain, snow and graupel seeded too so that
    every process has mass to act on."""
    rng = np.random.RandomState(seed)
    shape = (6, nz, n, n)
    p1d = np.linspace(5e3, 1.0e5, nz)
    p = np.broadcast_to(p1d[None, :, None, None], shape).copy()
    delp = np.broadcast_to(np.gradient(p1d)[None, :, None, None],
                           shape).copy()
    t = 300.0 - 60.0 * (1.0 - p / 1.0e5) + rng.randn(*shape)
    qsat_scale = 0.02 * (p / 1.0e5) ** 2
    qv = (0.9 if moist else 0.3) * qsat_scale * (1.0 + 0.3 * rng.rand(*shape))
    ql = 2e-3 * rng.rand(*shape) * (p > 4e4)
    qi = 5e-4 * rng.rand(*shape) * (t < 260.0)
    qr = 3e-4 * rng.rand(*shape)
    qs = 2e-4 * rng.rand(*shape) * (t < 275.0)
    qg = 1e-4 * rng.rand(*shape)
    dz = 287.0 * t / GRAV * delp / p
    return t, qv, ql, qi, qr, qs, qg, p, delp, dz


def _sounding(unstable=True, n=4, seed=0):
    """[6, 20, n, n] columns of tests/test_land_convection.py's sounding
    with seeded noise of 0.5 K and a seeded boundary-layer humidity:
    ``unstable=True`` puts its unstable profile (surface-based
    instability) in a seeded half of the columns and its stable one in
    the rest, so that some columns fire and some do not;
    ``unstable=False`` the stable profile everywhere."""
    nz = 20
    rng = np.random.RandomState(seed)
    pe = np.linspace(100e2, 1000e2, nz + 1)
    delp = np.diff(pe)
    p = 0.5 * (pe[1:] + pe[:-1])
    t_dry = 300.0 * (p / 1000e2) ** 0.286
    shape = (6, nz, n, n)

    def tile(a):
        return np.broadcast_to(a[None, :, None, None],
                               (6, a.shape[0], n, n)).copy()

    t_s = tile(t_dry + 30.0 * (1 - p / 1000e2))
    qv_s = tile(np.full_like(p, 1e-3))
    t_u = tile(t_dry - 6.0 * (1 - p / 1000e2))
    qv_u = tile(np.where(p > 800e2, 0.018, 0.002))
    pick = (rng.rand(6, 1, n, n) < 0.5) & unstable
    t = np.where(pick, t_u, t_s) + 0.5 * rng.randn(*shape)
    qv = np.where(pick, qv_u, qv_s) * rng.uniform(0.6, 1.1,
                                                  size=(6, 1, n, n))
    return t, qv, tile(p), tile(pe), tile(delp)


def _atmos(seed=0, u0=15.0, nz=20, n=3):
    """u, v, t, p, delp of tests/test_gwd_shalconv.py."""
    rng = np.random.RandomState(seed)
    shape = (6, nz, n, n)
    p1d = np.linspace(3e3, 1e5, nz)
    p = np.broadcast_to(p1d[None, :, None, None], shape).copy()
    delp = np.broadcast_to(np.gradient(p1d)[None, :, None, None],
                           shape).copy()
    t = 300.0 - 55.0 * (1 - p / 1e5) + 0.1 * rng.randn(*shape)
    u = np.full(shape, u0) + 0.1 * rng.randn(*shape)
    v = 0.1 * rng.randn(*shape)
    return u, v, t, p, delp


def _land_inputs(shape=(6, 3, 3), t1=295.0, q1=0.008, sw=600.0, seed=0,
                 precip=0.0):
    rng = np.random.RandomState(seed)
    return dict(
        t1=t1 + rng.randn(*shape),
        q1=q1 * rng.uniform(0.5, 1.0, size=shape),
        p_sfc=np.full(shape, 1.0e5),
        wind1=np.full(shape, 4.0),
        sw_down=sw * rng.uniform(0.5, 1.0, size=shape),
        lw_down=np.full(shape, 350.0),
        precip=np.full(shape, precip),
        ch=0.01 * rng.uniform(0.5, 1.5, size=shape),
    )


# --- parity against the JAX package -----------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_gfdl_cloud_microphysics_matches_jax(seed):
    args = _column_state(seed=seed)
    want_s, want_d = jmp.gfdl_cloud_microphysics(*map(_j, args), 900.0)
    got_s, got_d = tmp.gfdl_cloud_microphysics(*map(_t, args), 900.0)
    _close_dicts(got_s, want_s, "gfdl state")
    _close_dicts(got_d, want_d, "gfdl diags")
    # every process fired: rain, snow and graupel reach the surface
    for k in ("rain_precipitation", "snow_precipitation",
              "graupel_precipitation"):
        assert float(got_d[k].min()) > 0.0, k


def test_saturation_adjustment_and_sediment_match_jax():
    t, qv, ql, qi, qr, qs, qg, p, delp, dz = _column_state(seed=2)
    want = jmp.saturation_adjustment(*map(_j, (t, 3 * qv, ql, qi, p)), 4)
    got = tmp.saturation_adjustment(*map(_t, (t, 3 * qv, ql, qi, p)), 4)
    for k, g, w in zip("t qv ql qi".split(), got, want):
        assert_close_scaled(_np(g), _np(w), RTOL, name=f"sat adj {k}")
    q = np.zeros_like(qr)
    q[:, 5] = 1e-3
    for v in (1.0, 6.0):
        wq, wf = jmp._sediment(_j(q), _j(delp), _j(dz), v, 900.0)
        gq, gf = tmp._sediment(_t(q), _t(delp), _t(dz), v, 900.0)
        assert_close_scaled(_np(gq), _np(wq), RTOL, name=f"sediment {v} q")
        assert_close_scaled(_np(gf), _np(wf), RTOL, name=f"sediment {v} f")


@pytest.mark.parametrize("unstable", [True, False])
def test_sas_mass_flux_matches_jax(unstable):
    t, qv, p, pe, delp = _sounding(unstable=unstable)
    want = jconv.sas_mass_flux(*map(_j, (t, qv, p, pe, delp)), 900.0)
    got = tconv.sas_mass_flux(*map(_t, (t, qv, p, pe, delp)), 900.0)
    for k, g, w in zip(("t", "qv", "precip"), got, want):
        assert_close_scaled(_np(g), _np(w), RTOL, name=f"sas {k}")
    fired = int((_np(got[2]) > 0).sum())
    if unstable:
        # some columns fire and some do not: both branches compared
        assert 0 < fired < got[2].numel(), fired
        assert int((_np(want[2]) > 0).sum()) == fired
    else:
        assert fired == 0


def test_gravity_wave_drag_matches_jax():
    u, v, t, p, delp = _atmos()
    h = 400.0 * np.random.RandomState(5).rand(6, 3, 3)
    h[0] = 0.0  # a flat face: no stress
    want = jgwd.gravity_wave_drag(*map(_j, (u, v, t, p, delp, h)), 900.0)
    got = tgwd.gravity_wave_drag(*map(_t, (u, v, t, p, delp, h)), 900.0)
    assert_close_scaled(_np(got[0]), _np(want[0]), RTOL, name="gwd du")
    assert_close_scaled(_np(got[1]), _np(want[1]), RTOL, name="gwd dv")
    _close_dicts(got[2], want[2], "gwd diags")
    assert float(got[0].sum()) < 0.0


@pytest.mark.parametrize("case", ["sun", "snow", "wilting"])
def test_land_step_matches_jax(case):
    kw, smc0, t0 = {}, 0.25, 288.0
    if case == "snow":
        kw, t0 = dict(t1=263.0, sw=50.0, precip=1e-4), 268.0
    if case == "wilting":
        smc0, t0 = 0.05, 300.0
    inputs = _land_inputs(seed=3, **kw)
    shape = (6, 3, 3)
    js = jland.LandState.initial(shape, t0=t0, smc0=smc0, dtype=jnp.float64)
    ts = tland.LandState.initial(shape, t0=t0, smc0=smc0,
                                 dtype=torch.float64, device="cpu")
    for step in range(3):
        js, jf = jland.land_step(
            js, dt=600.0, **{k: _j(x) for k, x in inputs.items()})
        ts, tf = tland.land_step(
            ts, dt=600.0, **{k: _t(x) for k, x in inputs.items()})
        _close_dicts(tf, jf, f"land {case} fluxes {step}")
        _close_dicts(ts._asdict(), js._asdict(), f"land {case} state {step}")
    if case == "snow":
        assert float(ts.snow.min()) > 0.0


def _gfs_inputs(n=4, nz=16, seed=0):
    """A [6, nz, n, n] column set near saturation with cloud, seeded
    winds and a warm surface (tests/test_gfdl_mp.py's scheme-switch
    case with winds, and hydrometeors to carry)."""
    rng = np.random.RandomState(seed)
    shape = (6, nz, n, n)
    p1d = np.linspace(2e3, 1e5, nz)
    t = (300.0 - 55.0 * (1 - p1d / 1e5)[None, :, None, None]
         + rng.randn(*shape))
    qv = 0.9 * 0.02 * (p1d / 1e5)[None, :, None, None] ** 2 * np.ones(shape)
    qv = qv * rng.uniform(0.8, 1.15, size=(6, 1, n, n))
    qc = 2e-3 * rng.rand(*shape)
    delp = np.broadcast_to(np.gradient(p1d)[None, :, None, None],
                           shape).copy()
    u = 5.0 + 3.0 * rng.randn(6, nz, n + 1, n)
    v = 3.0 * rng.randn(6, nz, n, n + 1)
    tsfc = 302.0 + rng.randn(6, n, n)
    mp = (5e-4 * rng.rand(*shape) * (t < 260.0), 3e-4 * rng.rand(*shape),
          2e-4 * rng.rand(*shape) * (t < 275.0), 1e-4 * rng.rand(*shape))
    h_std = 300.0 * rng.rand(6, n, n)
    return (t, qv, qc, u, v, delp, tsfc), mp, h_std


GFS_CASES = {
    "gfdl_mp_tracers": dict(microphysics_scheme="gfdl"),
    "gfdl_two_tracers": dict(microphysics_scheme="gfdl"),
    "mass_flux": dict(convection_scheme="mass_flux"),
    "h_std": dict(),
}


@pytest.mark.parametrize("case", sorted(GFS_CASES))
def test_gfs_physics_step_options_match_jax(case):
    fields, mp, h_std = _gfs_inputs()
    kw = {}
    if case == "gfdl_mp_tracers":
        kw["mp_tracers"] = mp
    if case == "h_std":
        kw["h_std"] = h_std
    jcfg = jgfs.GFSPhysicsConfig(**GFS_CASES[case])
    tcfg = tgfs.GFSPhysicsConfig(**GFS_CASES[case])
    want = jgfs.gfs_physics_step(
        *map(_j, fields), 100.0, 900.0, cfg=jcfg,
        **{k: (tuple(map(_j, x)) if k == "mp_tracers" else _j(x))
           for k, x in kw.items()})
    got = tgfs.gfs_physics_step(
        *map(_t, fields), 100.0, 900.0, cfg=tcfg,
        **{k: (tuple(map(_t, x)) if k == "mp_tracers" else _t(x))
           for k, x in kw.items()})
    _close_dicts(got[0], want[0], f"{case} state")
    _close_dicts(got[1], want[1], f"{case} diags")
    if case == "gfdl_mp_tracers":
        assert set(tgfs.MP_TRACER_NAMES) <= set(got[0])
    if case == "mass_flux":
        assert float(got[1]["convective_precipitation"].max()) > 0.0
    if case == "h_std":
        assert float(got[1]["gwd_surface_stress"].max()) > 0.0


# --- the JAX package's closures, on the port ---------------------------------


def _water_path(qs, delp):
    return sum((_np(q) * _np(delp)).sum(1) for q in qs) / GRAV


def _torch_column_state(seed, dtype=torch.float32):
    """The JAX tests' f32 column state (no rain, snow or graupel)."""
    t, qv, ql, qi, _, _, _, p, delp, dz = _column_state(seed=seed)
    z = np.zeros_like(t)
    return tuple(torch.as_tensor(a, dtype=dtype)
                 for a in (t, qv, ql, qi, z, z, z, p, delp, dz))


def test_gfdl_water_conservation():
    t, qv, ql, qi, qr, qs, qg, p, delp, dz = _torch_column_state(0)
    st, dg = tmp.gfdl_cloud_microphysics(
        t, qv, ql, qi, qr, qs, qg, p, delp, dz, 900.0)
    before = _water_path((qv, ql, qi, qr, qs, qg), delp)
    after = _water_path([st[k] for k in (
        "specific_humidity", "cloud_water_mixing_ratio",
        "cloud_ice_mixing_ratio", "rain_mixing_ratio", "snow_mixing_ratio",
        "graupel_mixing_ratio")], delp)
    precip = _np(dg["total_precipitation_mp"])
    np.testing.assert_allclose(after + precip, before, rtol=2e-5)
    assert precip.min() >= 0.0


def test_gfdl_energy_conservation():
    t, qv, ql, qi, qr, qs, qg, p, delp, dz = _torch_column_state(1)
    st, dg = tmp.gfdl_cloud_microphysics(
        t, qv, ql, qi, qr, qs, qg, p, delp, dz, 900.0)

    def energy(tt, vv, ice_q):
        col = ((CP_AIR * _np(tt) + LV * _np(vv)) * _np(delp)).sum(1) / GRAV
        return col - LF * _water_path(ice_q, delp)

    e0 = energy(t, qv, (qi, qs, qg))
    e1 = energy(st["air_temperature"], st["specific_humidity"],
                [st[k] for k in ("cloud_ice_mixing_ratio",
                                 "snow_mixing_ratio", "graupel_mixing_ratio")])
    frozen = _np(dg["snow_precipitation"] + dg["graupel_precipitation"])
    np.testing.assert_allclose(e1 - LF * frozen, e0, rtol=2e-6)


def test_gfdl_saturation_adjustment_removes_supersaturation():
    t, qv, ql, qi, qr, qs, qg, p, delp, dz = _torch_column_state(2)
    t2, qv3, _, _ = tmp.saturation_adjustment(t, qv * 3.0, ql, qi, p, 4)
    qs_l = tmp._qsat(tmp.esat_liquid(t2), p)
    assert float((qv3 / qs_l).max()) < 1.25
    assert float((t2 - t).mean()) > 0.0


def test_gfdl_sedimentation_moves_mass_down_and_out():
    t, qv, ql, qi, qr, qs, qg, p, delp, dz = _torch_column_state(3)
    q = torch.zeros_like(qr)
    q[:, 5] = 1e-3
    q2, flux = tmp._sediment(q, delp, dz, 6.0, 900.0)
    m0 = float((q * delp).sum() / GRAV)
    m1 = float((q2 * delp).sum() / GRAV)
    np.testing.assert_allclose(m1 + float(flux.sum()), m0, rtol=1e-5)
    lev = torch.arange(q.shape[1])[None, :, None, None]
    com0 = float((q * lev).sum() / q.sum())
    com1 = float((q2 * lev).sum() / max(float(q2.sum()), 1e-30))
    assert com1 > com0 or float(q2.sum()) < 1e-12


def test_gfdl_mixed_phase_partition_and_bounded_collection():
    lf = tmp.liquid_fraction
    assert float(lf(torch.tensor(280.0))) == 1.0
    assert float(lf(torch.tensor(220.0))) == 0.0
    assert 0.4 < float(lf(torch.tensor(253.16))) < 0.6
    shp = (1, 4, 2, 2)
    full = lambda x: torch.full(shp, x, dtype=torch.float64)  # noqa: E731
    z = full(0.0)
    state, _ = tmp.gfdl_cloud_microphysics(
        full(280.0), full(1e-3), full(2e-3), z, full(5.0), z, z, full(8e4),
        full(200.0), full(-500.0), 36000.0)
    for k, v in state.items():
        assert bool(torch.isfinite(v).all()), k
        if k != "air_temperature":
            assert bool((v >= -1e-12).all()), k


def test_gfs_scheme_switch_changes_precip():
    (t, qv, qc, _, _, delp, _), _, _ = _gfs_inputs(seed=0)
    n, nz = t.shape[-1], t.shape[1]
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    u = torch.zeros((6, nz, n + 1, n))
    v = torch.zeros((6, nz, n, n + 1))
    tsfc = torch.full((6, n, n), 302.0)
    out = {}
    for scheme in ("zhao_carr", "gfdl"):
        cfg = tgfs.GFSPhysicsConfig(microphysics_scheme=scheme,
                                    do_convection=False, do_pbl=False,
                                    do_surface=False)
        _, dg = tgfs.gfs_physics_step(f32(t), f32(qv), f32(qc), u, v,
                                      f32(delp), tsfc, 100.0, 900.0, cfg=cfg)
        out[scheme] = _np(dg["large_scale_precipitation"])
        assert np.isfinite(out[scheme]).all() and out[scheme].sum() > 0.0
    diff = np.abs(out["gfdl"] - out["zhao_carr"]).mean()
    assert diff > 0.05 * np.abs(out["zhao_carr"]).mean()


def test_sas_conserves_column_mse_and_water():
    t, qv, p, pe, delp = map(_t, _sounding(unstable=True))
    dt = 900.0
    t2, qv2, precip = tconv.sas_mass_flux(t, qv, p, pe, delp, dt)
    assert float(precip.max()) > 0.0
    m = delp / GRAV
    for c in range(6):
        sl = np.s_[c]
        mse0 = float(((CP_AIR * t + LV * qv) * m)[sl].sum())
        mse1 = float(((CP_AIR * t2 + LV * qv2) * m)[sl].sum())
        assert abs(mse1 - mse0) / abs(mse0) < 2e-4
    w0 = _np((qv * m).sum(1))
    w1 = _np((qv2 * m).sum(1))
    np.testing.assert_allclose(w0 - w1, _np(precip) * dt, rtol=1e-5,
                               atol=1e-12)
    assert float(qv2.min()) >= 0.0


def test_sas_quiet_on_stable_column_and_stabilizes():
    t, qv, p, pe, delp = map(_t, _sounding(unstable=False))
    t2, qv2, precip = tconv.sas_mass_flux(t, qv, p, pe, delp, 900.0)
    assert float(precip.max()) == 0.0
    np.testing.assert_allclose(_np(t2), _np(t))
    np.testing.assert_allclose(_np(qv2), _np(qv))
    t, qv, p, pe, delp = map(_t, _sounding(unstable=True))

    def instability(tt, qq):
        h = CP_AIR * tt + LV * qq
        hsat = CP_AIR * tt + LV * tgfs.qsat(tt, p)
        return float((h[:, -1] - hsat[:, 5]).max())

    i0 = instability(t, qv)
    for _ in range(8):
        t, qv, _ = tconv.sas_mass_flux(t, qv, p, pe, delp, 900.0)
    assert instability(t, qv) < i0


def test_gwd_noop_decelerates_and_conserves_momentum():
    u, v, t, p, delp = (torch.as_tensor(a, dtype=torch.float32)
                        for a in _atmos())
    du, dv, _ = tgwd.gravity_wave_drag(u, v, t, p, delp,
                                       torch.zeros((6, 3, 3)), 900.0)
    assert float(du.abs().max()) == 0.0 and float(dv.abs().max()) == 0.0
    dt = 900.0
    du, dv, dg = tgwd.gravity_wave_drag(
        u, v, t, p, delp, torch.full((6, 3, 3), 400.0), dt)
    assert float(du.sum()) < 0.0
    assert bool(((u + du) >= -1e-3).all())
    dM = _np((du * delp / GRAV).sum(dim=1)) / dt
    tau_net = _np(dg["gwd_surface_stress"]) - _np(dg["gwd_top_stress"])
    assert (np.abs(dM) <= tau_net * (1 + 1e-3) + 1e-10).all()
    assert (-dM > 0.25 * tau_net).any()
    u20 = torch.as_tensor(_atmos(u0=20.0)[0], dtype=torch.float32)
    du, _, _ = tgwd.gravity_wave_drag(
        u20, v, t, p, delp, torch.full((6, 3, 3), 300.0), 900.0)
    assert float(du.abs().max()) < 10.0


def test_shallow_convection_conserves_and_moistens_aloft():
    u, v, t, p, delp = (torch.as_tensor(a, dtype=torch.float32)
                        for a in _atmos(seed=3))
    qv = torch.where(p > 8.5e4, 0.016, 0.002).to(torch.float32)
    t = t.clone()
    t[:, -1] += 4.0
    t2, qv2, dg = tgwd.shallow_convection(t, qv, p, delp, 900.0)
    w = _np(delp) / GRAV
    np.testing.assert_allclose((_np(qv2) * w).sum(1), (_np(qv) * w).sum(1),
                               rtol=1e-5)
    h0 = ((CP_AIR * _np(t) + LV * _np(qv)) * w).sum(1)
    h1 = ((CP_AIR * _np(t2) + LV * _np(qv2)) * w).sum(1)
    np.testing.assert_allclose(h1, h0, rtol=1e-6)
    dq = _np(qv2 - qv)
    assert dq[:, -1].mean() < 0.0 and dq[:, -4].mean() > 0.0
    assert _np(dg["shallow_convection_active"]).any()


def test_land_surface_energy_closure():
    state = tland.LandState.initial((2, 2), t0=288.0, smc0=0.25,
                                    device="cpu")
    dt = 600.0
    inputs = {k: torch.as_tensor(x[0, :2, :2], dtype=torch.float32)
              for k, x in _land_inputs(sw=600.0).items()}
    for k in inputs:  # uniform forcing, as the JAX package's test
        inputs[k] = torch.full_like(inputs[k], float(inputs[k][0, 0]))
    new, fx = tland.land_step(state, dt=dt, **inputs)
    resid = (fx["net_radiation_land"] - fx["sensible_heat_flux_land"]
             - fx["latent_heat_flux_land"] - fx["ground_heat_flux"])
    scale = float(fx["net_radiation_land"].abs().max()) + 1.0
    assert float(resid.abs().max()) < 0.05 * scale
    cfg = tland.LandConfig()
    storage = sum(cfg.soil_heat_capacity * tland.DZ_SOIL[i]
                  * _np(new.stc[i] - state.stc[i]) / dt for i in range(4))
    g_bot = 2.0 * cfg.soil_conductivity / tland.DZ_SOIL[3] * (
        _np(new.stc[3]) - cfg.t_deep)
    np.testing.assert_allclose(storage, _np(fx["ground_heat_flux"]) - g_bot,
                               rtol=5e-4, atol=5e-2)


def test_land_warms_dries_snows_and_wilts():
    def inputs(**kw):
        out = dict(t1=295.0, q1=0.008, p_sfc=1.0e5, wind1=4.0, sw_down=800.0,
                   lw_down=350.0, precip=0.0, ch=0.01)
        out.update(kw)
        return {k: torch.full((2, 2), v) for k, v in out.items()}

    state = tland.LandState.initial((2, 2), t0=285.0, smc0=0.25,
                                    device="cpu")
    for _ in range(24):
        state, fx = tland.land_step(state, dt=600.0, **inputs())
    assert float(state.tskin.mean()) > 285.0
    assert float(state.smc[0].mean()) < 0.25
    assert float(fx["latent_heat_flux_land"].mean()) > 0.0
    assert float(state.stc[0].mean()) > 285.0
    cfg = tland.LandConfig()
    state = tland.LandState.initial((2, 2), t0=300.0, smc0=cfg.smc_wilt / 2,
                                    device="cpu")
    _, fx = tland.land_step(state, dt=600.0, cfg=cfg, **inputs(sw_down=600.0))
    assert float(fx["latent_heat_flux_land"].max()) == 0.0
    state = tland.LandState.initial((2, 2), t0=268.0, device="cpu")
    state, _ = tland.land_step(
        state, dt=600.0, **inputs(t1=263.0, sw_down=50.0, precip=1e-4))
    assert float(state.snow.min()) > 0.0
    assert float(state.tskin.max()) <= 273.16 + 1e-3


def test_land_state_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="LandState.initial"):
        tland.LandState.initial((2, 2))
    assert dataclasses.is_dataclass(tland.LandConfig())
