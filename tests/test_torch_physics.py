"""The port's column physics (physics/{gfs,gwd,simple,radiation}.py,
runtime/steppers.non_negative_sphum, the wrapper's thermodynamic
conversions) against the JAX package's, on the same seeded columns in
float64 on the CPU.  Each test also checks that its inputs take both
sides of every threshold of the function (rib < 0, precip > 0,
supersaturation, the contiguity cumprods, ...)."""

import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu import wrapper as jwrapper
from fv3net_tpu.physics import gfs as jgfs
from fv3net_tpu.physics import gwd as jgwd
from fv3net_tpu.physics import radiation as jrad
from fv3net_tpu.physics import simple as jsimple
from fv3net_tpu.runtime.steppers import non_negative_sphum as j_nns
from fv3net_tpu_torch import wrapper as twrapper
from fv3net_tpu_torch.physics import gfs as tgfs
from fv3net_tpu_torch.physics import gwd as tgwd
from fv3net_tpu_torch.physics import radiation as trad
from fv3net_tpu_torch.physics import simple as tsimple
from fv3net_tpu_torch.runtime.steppers import non_negative_sphum as t_nns
from torch_parity import assert_close_scaled

torch.set_num_threads(1)

N, NZ, PTOP, DT = 4, 16, 300.0, 900.0
# float64, the same operations in the same order; exp/log/pow may differ
# by an ulp between XLA and torch, and the level recurrences (Thomas
# solve, parcel lift, rain fall) carry that over nz steps
RTOL = 1e-11


def _columns(seed=0):
    """Seeded [6, NZ, N, N] columns spanning both sides of the suite's
    thresholds: a warm moist surface under half the columns (unstable
    surface layer, deep buoyant parcels) and a cold dry one under the
    rest; humidity from subsaturated to supersaturated; some cloud."""
    rng = np.random.RandomState(seed)
    eta = np.linspace(0.02, 1.0, NZ + 1)
    pe = PTOP + (1.0e5 - PTOP) * eta ** 1.5
    pe = pe[None, :, None, None] * (1.0 + 0.02 * rng.rand(6, 1, N, N))
    delp = pe[:, 1:] - pe[:, :-1]
    p = 0.5 * (pe[:, 1:] + pe[:, :-1])
    warm = (np.arange(6 * N * N).reshape(6, 1, N, N) % 2) == 0
    t_sfc_air = np.where(warm, 300.0, 270.0)
    t = t_sfc_air * (p / 1.0e5) ** 0.19 + rng.randn(6, NZ, N, N)
    rh = np.where(warm, 0.7, 0.3) + 0.5 * rng.rand(6, NZ, N, N)
    tc = t - 273.15
    es = 611.2 * np.exp(17.67 * tc / (tc + 243.5))
    qv = rh * 0.622 * es / p
    qc = np.where(rng.rand(6, NZ, N, N) < 0.5, 1e-4 * rng.rand(6, NZ, N, N),
                  0.0)
    u = 10.0 * rng.randn(6, NZ, N + 1, N)
    v = 10.0 * rng.randn(6, NZ, N, N + 1)
    tsfc = np.where(warm[:, 0], 305.0, 260.0) + rng.randn(6, N, N)
    return dict(t=t, qv=qv, qc=qc, u=u, v=v, delp=delp, p=p, pe=pe,
                tsfc=tsfc)


C = _columns()


def _convective_columns():
    """C with its warm columns replaced by a nearly saturated environment
    0.3 K cooler than the lifted parcel: those columns convect and
    precipitate, the cold ones do not."""
    t_par, _, _ = jgfs.moist_adiabat(
        jnp.asarray(C["t"]), jnp.asarray(C["qv"]), jnp.asarray(C["p"])
    )
    warm = (np.arange(6 * N * N).reshape(6, 1, N, N) % 2) == 0
    t = np.where(warm, np.asarray(t_par) - 0.3, C["t"])
    qs = np.asarray(jgfs.qsat(jnp.asarray(t), jnp.asarray(C["p"])))
    return dict(C, t=t, qv=np.where(warm, 0.95 * qs, C["qv"]))


CONV = _convective_columns()


def _both(a, b, name):
    """The two packages' results, compared field by field."""
    if isinstance(b, dict):
        assert set(a) == set(b), name
        for k in b:
            _both(a[k], b[k], f"{name}.{k}")
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            _both(x, y, f"{name}[{i}]")
    else:
        got = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert np.shape(got) == np.shape(b), name
        assert_close_scaled(got, np.asarray(b), RTOL, name)


def _run(jfn, tfn, *args, **kw):
    """jfn on jnp arrays, tfn on torch tensors of the same numpy args;
    returns (torch result, jax result)."""
    def conv(x, f):
        return f(np.array(x)) if isinstance(x, np.ndarray) else x

    want = jfn(*(conv(a, jnp.asarray) for a in args), **kw)
    got = tfn(*(conv(a, torch.as_tensor) for a in args), **kw)
    return got, want


def test_saturation_helpers():
    for name in ("esat", "qsat", "dqsat_dt"):
        args = (C["t"],) if name == "esat" else (C["t"], C["p"])
        got, want = _run(getattr(jgfs, name), getattr(tgfs, name), *args)
        _both(got, want, name)
    # the 0.99 p cap of qsat binds at hot, thin levels
    hot = jgfs.esat(jnp.asarray(C["t"] + 80.0)) > 0.99 * C["p"]
    assert bool(hot.any()) and not bool(hot.all())
    got, want = _run(jgfs.qsat, tgfs.qsat, C["t"] + 80.0, C["p"])
    _both(got, want, "qsat capped")


def test_pressure_fields_and_layer_geometry():
    got, want = _run(jgfs.pressure_fields, tgfs.pressure_fields,
                     C["delp"], PTOP)
    _both(got, want, "pressure_fields")
    pe = want[0]
    got, want = _run(jgfs.layer_geometry, tgfs.layer_geometry,
                     C["t"], C["qv"], C["delp"], np.asarray(pe))
    _both(got, want, "layer_geometry")


def _surface_args():
    pe, p = jgfs.pressure_fields(jnp.asarray(C["delp"]), PTOP)
    _, z_mid = jgfs.layer_geometry(
        jnp.asarray(C["t"]), jnp.asarray(C["qv"]), jnp.asarray(C["delp"]), pe
    )
    ua, va = jgfs._to_agrid(jnp.asarray(C["u"]), jnp.asarray(C["v"]))
    return tuple(np.asarray(a) for a in (
        C["t"][:, -1], C["qv"][:, -1], ua[:, -1], va[:, -1], pe[:, -1],
        p[:, -1], z_mid[:, -1], C["tsfc"],
    ))


def test_surface_exchange_both_stabilities():
    cfg = jgfs.GFSPhysicsConfig()
    got, want = _run(
        lambda *a: jgfs.surface_exchange(*a, cfg),
        lambda *a: tgfs.surface_exchange(*a, tgfs.GFSPhysicsConfig()),
        *_surface_args(),
    )
    rib = np.asarray(want[-1])
    assert (rib < 0).any() and (rib >= 0).any()
    _both(got, want, "surface_exchange")


def test_tridiagonal_solve():
    rng = np.random.RandomState(1)
    a = -rng.rand(6, NZ, N, N)
    c = -rng.rand(6, NZ, N, N)
    b = 2.5 + rng.rand(6, NZ, N, N)
    d = rng.randn(6, NZ, N, N)
    got, want = _run(jgfs.tridiagonal_solve, tgfs.tridiagonal_solve,
                     a, b, c, d)
    _both(got, want, "tridiagonal_solve")
    # and it solves the system
    x = got.numpy()
    r = b * x
    r[:, 1:] += a[:, 1:] * x[:, :-1]
    r[:, :-1] += c[:, :-1] * x[:, 1:]
    np.testing.assert_allclose(r, d, atol=1e-12)


def test_rho_layer_mass():
    got, want = _run(jgfs.rho_layer_mass, tgfs.rho_layer_mass,
                     C["delp"])
    assert got.dtype == torch.float64
    _both(got, want, "rho_layer_mass")


def test_pbl_height_and_k_profile():
    cfg = jgfs.GFSPhysicsConfig()
    tcfg = tgfs.GFSPhysicsConfig()
    t, qv, p = C["t"], C["qv"], C["p"]
    thv = t * (1e5 / p) ** (jgfs.RDGAS / jgfs.CP_AIR) * (1 + jgfs.ZVIR * qv)
    _, z_mid = jgfs.layer_geometry(
        jnp.asarray(t), jnp.asarray(qv), jnp.asarray(C["delp"]),
        jgfs.pressure_fields(jnp.asarray(C["delp"]), PTOP)[0],
    )
    z_mid = np.asarray(z_mid)
    ua, va = (np.asarray(x) for x in jgfs._to_agrid(
        jnp.asarray(C["u"]), jnp.asarray(C["v"])
    ))
    got, want = _run(
        lambda *a: jgfs.pbl_height(*a, cfg),
        lambda *a: tgfs.pbl_height(*a, tcfg),
        thv, z_mid, ua, va,
    )
    _both(got, want, "pbl_height")
    # both sides of the ri_crit threshold and of the floor at z_mid[-1]
    h = np.asarray(want)
    assert (h > z_mid[:, -1]).any() and (h == z_mid[:, -1]).any()
    z_if = 0.5 * (z_mid[:, :-1] + z_mid[:, 1:])
    ustar = 0.3 + np.random.RandomState(2).rand(6, N, N)
    got, want = _run(
        lambda *a: jgfs.k_profile(*a, cfg),
        lambda *a: tgfs.k_profile(*a, tcfg),
        z_if, h, ustar,
    )
    k = np.asarray(want)
    assert (k == cfg.k_background).any() and (k > cfg.k_background).any()
    _both(got, want, "k_profile")


@pytest.mark.parametrize("sfc_dims", [3, 4])
def test_diffuse_column(sfc_dims):
    rng = np.random.RandomState(3)
    mass = C["delp"] / 9.80665
    g_if = rng.rand(6, NZ - 1, N, N)
    shape = (6, 1, N, N) if sfc_dims == 4 else (6, N, N)
    sfc_g = rng.rand(*shape)
    x_sfc = rng.randn(6, N, N)
    got, want = _run(jgfs.diffuse_column, tgfs.diffuse_column,
                     C["t"], mass, g_if, DT, sfc_g, x_sfc)
    _both(got, want, "diffuse_column")


def test_moist_adiabat_and_betts_miller():
    got, want = _run(jgfs.moist_adiabat, tgfs.moist_adiabat,
                     C["t"], C["qv"], C["p"])
    active = np.asarray(want[2])
    assert got[2].dtype == torch.bool
    # contiguous buoyant regions of several depths, and none
    depth = active.sum(axis=1)
    assert (depth > 1).any() and (depth <= 1).any()
    _both(got[:2], want[:2], "moist_adiabat")
    np.testing.assert_array_equal(got[2].numpy(), active)
    cfg = jgfs.GFSPhysicsConfig()
    got, want = _run(
        lambda *a: jgfs.betts_miller(*a, cfg),
        lambda *a: tgfs.betts_miller(*a, tgfs.GFSPhysicsConfig()),
        CONV["t"], CONV["qv"], CONV["p"], CONV["delp"], DT,
    )
    precip = np.asarray(want[2])
    assert (precip > 0).any() and (precip == 0).any()
    _both(got, want, "betts_miller")


def test_gscond_and_precpd():
    got, want = _run(jgfs.gscond, tgfs.gscond,
                     C["t"], C["qv"], C["qc"], C["p"], DT)
    dq = np.asarray(want[1]) - C["qv"]
    assert (dq < 0).any() and (dq > 0).any()  # condensation and evaporation
    _both(got, want, "gscond")
    cfg = jgfs.GFSPhysicsConfig()
    qc = C["qc"] + 5e-4  # rain everywhere, falling into dry and moist air
    got, want = _run(
        lambda *a: jgfs.precpd(*a, cfg),
        lambda *a: tgfs.precpd(*a, tgfs.GFSPhysicsConfig()),
        C["t"], C["qv"], qc, C["p"], C["delp"], DT,
    )
    evap = np.asarray(want[1]) - C["qv"]
    assert (evap > 0).any() and (evap == 0).any()
    assert (np.asarray(want[3]) > 0).all()
    _both(got, want, "precpd")


def test_shallow_convection():
    got, want = _run(jgwd.shallow_convection, tgwd.shallow_convection,
                     C["t"], C["qv"], C["p"], C["delp"], DT)
    active = np.asarray(want[2]["shallow_convection_active"])
    assert (active == 1).any() and (active == 0).any()
    _both(got, want, "shallow_convection")


@pytest.mark.parametrize("axis", [1, -3, 0])
def test_brunt_vaisala_axis(axis):
    """N^2 along the level axis at 1 (the drag's), its negative form, and
    with the levels moved to axis 0."""
    t, p = C["t"], C["p"]
    if axis == 0:
        t, p = np.moveaxis(t, 1, 0), np.moveaxis(p, 1, 0)
    got, want = _run(jgwd.brunt_vaisala, tgwd.brunt_vaisala, t, p,
                     axis=axis)
    assert np.shape(want)[axis] == NZ - 1
    _both(got, want, f"brunt_vaisala axis={axis}")


def test_saturation_adjustment():
    got, want = _run(jsimple.saturation_adjustment,
                     tsimple.saturation_adjustment,
                     C["t"], C["qv"], C["qc"], C["p"], C["delp"], DT)
    dq = np.asarray(want[1]) - C["qv"]
    assert (dq < 0).any() and (dq > 0).any()
    _both(got, want, "saturation_adjustment")


CONFIGS = {
    "default": {},
    "no_surface": dict(do_surface=False),
    "no_pbl": dict(do_pbl=False),
    "no_convection": dict(do_convection=False, do_shallow_convection=False,
                          do_microphysics=False),
}


@pytest.mark.parametrize("variant", sorted(CONFIGS))
def test_gfs_physics_step(variant):
    kw = CONFIGS[variant]
    got, want = _run(
        lambda *a: jgfs.gfs_physics_step(
            *a, cfg=jgfs.GFSPhysicsConfig(**kw)
        ),
        lambda *a: tgfs.gfs_physics_step(
            *a, cfg=tgfs.GFSPhysicsConfig(**kw)
        ),
        *(CONV[k] for k in ("t", "qv", "qc", "u", "v", "delp", "tsfc")),
        PTOP, DT,
    )
    _both(got, want, f"gfs_physics_step {variant}")
    if variant == "default":
        precip = np.asarray(want[1]["convective_precipitation"])
        assert (precip > 0).any() and (precip == 0).any()


@pytest.mark.parametrize("kw,match", [
    (dict(convection_scheme="mass_flux"), "convection.py"),
    (dict(microphysics_scheme="gfdl"), "gfdl_mp.py"),
])
def test_gfs_unported_options_raise(kw, match):
    """The options that raised before their modules were ported (the
    mass-flux convection, the GFDL microphysics, the gravity-wave drag
    through h_std) now run the module named by `match` and agree with the
    JAX package (tests/test_torch_gfdl.py holds them in depth)."""
    import sys

    fields = [CONV[k] for k in ("t", "qv", "qc", "u", "v", "delp", "tsfc")]
    h_std = 300.0 * np.random.RandomState(6).rand(*CONV["tsfc"].shape)
    for extra in ({}, {"h_std": h_std}):
        got, want = _run(
            lambda *a: jgfs.gfs_physics_step(
                *a[:-1], cfg=jgfs.GFSPhysicsConfig(**kw),
                **({"h_std": a[-1]} if extra else {})),
            lambda *a: tgfs.gfs_physics_step(
                *a[:-1], cfg=tgfs.GFSPhysicsConfig(**kw),
                **({"h_std": a[-1]} if extra else {})),
            *fields, PTOP, DT, h_std,
        )
        _both(got, want, f"gfs_physics_step {kw} {sorted(extra)}")
    assert "fv3net_tpu_torch.physics." + match[:-3] in sys.modules
    assert "gwd_surface_stress" in got[1]


def test_radiation_core_and_radupdate():
    time = datetime.datetime(2016, 8, 1, 6)
    jd, td = jrad.RadiationDriver(), trad.RadiationDriver()
    jd.radupdate(time)
    td.radupdate(time)
    np.testing.assert_allclose(td._solcon, float(jd._solcon), rtol=1e-14)
    rng = np.random.RandomState(4)
    cosz = np.maximum(rng.rand(6, N, N) - 0.3, 0.0)  # night and day
    got, want = _run(
        jd._core, td._core, cosz, C["p"], C["delp"], C["t"], C["qv"],
        C["tsfc"], float(jd._solcon),
    )
    _both(got, want, "radiation _core")
    # the host driver: cos zenith from lon/lat at the time
    lon = np.rad2deg(rng.rand(6, N, N) * 2 * np.pi)
    lat = np.rad2deg((rng.rand(6, N, N) - 0.5) * np.pi)
    got, want = _run(
        lambda *a: jd.gfs_radiation_driver(time, lon, lat, *a),
        lambda *a: td.gfs_radiation_driver(time, lon, lat, *a),
        C["p"], C["delp"], C["t"], C["qv"], C["tsfc"],
    )
    _both(got, want, "gfs_radiation_driver")


def test_non_negative_sphum_both_branches():
    rng = np.random.RandomState(5)
    q = 1e-3 * rng.rand(6, NZ, N, N)
    dQ1 = 1e-5 * rng.randn(6, NZ, N, N)
    dQ2 = 3e-6 * rng.randn(6, NZ, N, N)  # some drive q below zero
    dQ2[0, 0, 0, 0] = 0.0
    assert ((q + dQ2 * DT) < 0).any() and ((q + dQ2 * DT) > 0).any()
    got, want = _run(lambda *a: j_nns(*a, DT), lambda *a: t_nns(*a, DT),
                     q, dQ1, dQ2)
    _both(got, want, "non_negative_sphum")
    assert (q + got[1].numpy() * DT >= -1e-18).all()


def test_thermodynamic_conversions():
    pt = 300.0 + np.random.RandomState(6).randn(6, NZ, N, N)
    for name, args in (
        ("pressure_layers", (C["delp"], PTOP)),
        ("temperature_from_pt", (C["delp"], pt, C["qv"], PTOP)),
        ("pt_from_temperature", (C["delp"], C["t"], C["qv"], PTOP)),
    ):
        got, want = _run(getattr(jwrapper, name), getattr(twrapper, name),
                         *args)
        _both(got, want, name)
