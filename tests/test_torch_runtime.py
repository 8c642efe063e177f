"""The eager coupling runtime of fv3net_tpu_torch against the JAX
package's: every case of tests/test_runtime.py (wrapper API, steppers,
monitor diagnostics, metrics) on the port, compared with the JAX
package's result where the case computes one, and the state and
diagnostics after two TimeLoop steps in three configurations (the simple
suite with an ML stepper, Held-Suarez with the "none" suite and a
nudger, the gfs suite with gray radiation and an SST prescriber), C6 x
8, hydrostatic, float64 on the CPU, from the same seeded moist state."""

import datetime

import jax
import numpy as np
import pytest
import torch

from fv3net_tpu import wrapper as jwrapper
from fv3net_tpu.runtime import derived_state as jderived
from fv3net_tpu.runtime import loop as jloop
from fv3net_tpu.runtime import metrics as jmetrics
from fv3net_tpu.runtime import steppers as jsteppers
from fv3net_tpu.util.quantity import Quantity as JQuantity
from fv3net_tpu_torch import wrapper as twrapper
from fv3net_tpu_torch.runtime import derived_state as tderived
from fv3net_tpu_torch.runtime import loop as tloop
from fv3net_tpu_torch.runtime import metrics as tmetrics
from fv3net_tpu_torch.runtime import names
from fv3net_tpu_torch.runtime import steppers as tsteppers
from fv3net_tpu_torch.util.quantity import Quantity
from torch_parity import assert_close_scaled

torch.set_num_threads(1)

N, NZ, DT = 6, 8, 600.0
CFG = dict(npx=N + 1, npz=NZ, dt_atmos=DT, n_split=4, dtype="float64")
# float64 in both packages; the hydrostatic dycore agrees to ~1e-13 of
# each field over a dt (tests/test_torch_hydrostatic.py) and the physics
# to roundoff.  Over two steps every field and diagnostic of the three
# configurations agrees to <= 7.5e-11 of its magnitude (measured; the
# worst is storage_of_mass_due_to_python, a difference of nearly equal
# delp), so 1e-9 of each field's magnitude
RTOL = 1e-9
PKGS = {
    "jax": (jwrapper, jloop, jsteppers, jderived, JQuantity),
    "torch": (twrapper, tloop, tsteppers, tderived, Quantity),
}


_JAX_RUN_STEP = []


def _init(pkg, **kw):
    """Initialize `pkg`'s wrapper with CFG and `kw`.  Every configuration
    here has the same dycore (CFG), so the JAX model reuses the first
    jitted dycore step instead of compiling an identical one again."""
    wrapper = PKGS[pkg][0]
    cfg = wrapper.ModelConfig(**dict(CFG, **kw))
    if pkg == "torch":
        wrapper.initialize(cfg, device="cpu")
        return wrapper.get_model()
    wrapper.initialize(cfg)
    mdl = wrapper.get_model()
    if _JAX_RUN_STEP:
        mdl.run_step = _JAX_RUN_STEP[0]
    else:
        _JAX_RUN_STEP.append(mdl.run_step)
    return mdl


def _np(x):
    """A host copy (the JAX package accumulates total_precip in place)."""
    return x.numpy().copy() if isinstance(x, torch.Tensor) else np.array(x)


@pytest.fixture(scope="module")
def models():
    return _init("jax"), _init("torch")


def test_initialize_hydrostatic_default_config(models):
    """The default config is hydrostatic (no w, delz) and the port's
    initial state equals the JAX package's bit for bit."""
    jm, tm = models
    assert tm.config.hydrostatic
    assert tm.state.w is None and tm.state.delz is None
    for k in ("delp", "pt", "u", "v", "q"):
        np.testing.assert_array_equal(
            _np(getattr(tm.state, k)), np.asarray(getattr(jm.state, k)), k
        )
    assert tm.state.delp.device.type == "cpu"


def test_wrapper_state_roundtrip(models):
    st = twrapper.get_state([names.TEMP, names.DELP, names.SPHUM])
    assert st[names.TEMP].dims == ("tile", "z", "y", "x")
    t0 = st[names.TEMP].values.copy()
    want = jwrapper.get_state([names.TEMP])[names.TEMP].values
    assert_close_scaled(t0, want, 1e-14, name="temperature")
    twrapper.set_state({names.TEMP: st[names.TEMP].with_data(t0 + 1.0)})
    t1 = twrapper.get_state([names.TEMP])[names.TEMP].values
    np.testing.assert_allclose(t1, t0 + 1.0, rtol=1e-10)
    twrapper.set_state({names.TEMP: st[names.TEMP].with_data(t0)})


def test_wrapper_mass_conserving_humidity_set(models):
    out = {}
    for pkg in PKGS:
        wrapper = PKGS[pkg][0]
        st = wrapper.get_state([names.SPHUM, names.DELP])
        q0 = st[names.SPHUM].values
        dp0 = st[names.DELP].values
        wrapper.set_state_mass_conserving(
            {names.SPHUM: st[names.SPHUM].with_data(q0 + 1e-4)}
        )
        st2 = wrapper.get_state([names.SPHUM, names.DELP])
        out[pkg] = st2[names.DELP].values
        dry1 = (out[pkg] * (1 - st2[names.SPHUM].values)).sum()
        np.testing.assert_allclose(dry1, (dp0 * (1 - q0)).sum(), rtol=1e-10)
        wrapper.set_state({names.SPHUM: st[names.SPHUM].with_data(q0),
                           names.DELP: st[names.DELP].with_data(dp0)})
    np.testing.assert_array_equal(out["torch"], out["jax"])


def test_wrapper_agrid_to_dgrid_transform(models):
    jm, tm = models
    n, nz = tm.n, tm.nz
    ua = Quantity(np.ones((6, nz, n, n)), ("tile", "z", "y", "x"), "m/s")
    va = Quantity(np.zeros((6, nz, n, n)), ("tile", "z", "y", "x"), "m/s")
    du, dv = twrapper.transform_agrid_winds_to_dgrid_winds(ua, va)
    jdu, jdv = jwrapper.transform_agrid_winds_to_dgrid_winds(ua, va)
    assert du.data.shape == (6, nz, n + 1, n)
    assert dv.data.shape == (6, nz, n, n + 1)
    np.testing.assert_array_equal(du.values, jdu.values)
    np.testing.assert_array_equal(dv.values, jdv.values)
    # an eastward unit vector has bounded covariant components
    assert np.abs(du.values).max() <= 1.0 + 1e-6
    # round trip: away from the poles the flow comes back
    twrapper.set_state({names.X_WIND: du, names.Y_WIND: dv})
    jwrapper.set_state({names.X_WIND: jdu, names.Y_WIND: jdv})
    ua2, va2 = tm._agrid_winds()
    jua2, jva2 = jm._agrid_winds()
    np.testing.assert_array_equal(ua2, jua2)
    np.testing.assert_array_equal(va2, jva2)
    ok = np.abs(tm.lat) < 1.0
    sel = np.broadcast_to(ok[:, None], ua2.shape)
    assert np.abs(ua2[sel] - 1.0).mean() < 0.05
    assert np.abs(va2[sel]).mean() < 0.12
    east = twrapper.get_state([names.EASTWARD_WIND])
    np.testing.assert_array_equal(east[names.EASTWARD_WIND].values, ua2)
    for wrapper, u, v in ((twrapper, du, dv), (jwrapper, jdu, jdv)):
        wrapper.set_state({
            names.X_WIND: u.with_data(np.zeros_like(u.values)),
            names.Y_WIND: v.with_data(np.zeros_like(v.values)),
        })


def test_tracer_metadata(models):
    md = twrapper.get_tracer_metadata()
    assert md == jwrapper.get_tracer_metadata()
    assert md[names.SPHUM]["i_tracer"] == 1


def test_properties_and_surface_fields(models):
    assert twrapper._properties.DYNAMICS_PROPERTIES == \
        jwrapper._properties.DYNAMICS_PROPERTIES
    assert twrapper._properties.PHYSICS_PROPERTIES == \
        jwrapper._properties.PHYSICS_PROPERTIES
    for name in (names.TSFC, names.TOTAL_PRECIP, names.AREA, "latitude",
                 "longitude", "surface_geopotential",
                 "surface_precipitation_rate"):
        got = twrapper.get_state([name])[name]
        want = jwrapper.get_state([name])[name]
        assert got.dims == want.dims and got.units == want.units, name
        np.testing.assert_array_equal(got.values, want.values, name)


class ConstantTendencyModel:
    """Mock Predictor (cf. tests/machine_learning_mocks.py:31)."""

    input_variables = [names.TEMP, names.SPHUM]

    def __init__(self, dq1=1e-5, dq2=0.0):
        self.dq1 = dq1
        self.dq2 = dq2

    def predict(self, state):
        t = state[names.TEMP]
        return {
            "dQ1": t.with_data(np.full_like(t.values, self.dq1)),
            "dQ2": t.with_data(np.full_like(t.values, self.dq2)),
        }


def test_non_negative_sphum_limiter():
    sphum = np.array([1e-3, 1e-6])
    dQ1 = np.array([0.0, 0.0])
    dQ2 = np.array([-1e-6, -1e-6])  # second one would drive negative
    d1, d2 = tsteppers.non_negative_sphum(
        *(torch.as_tensor(a) for a in (sphum, dQ1, dQ2)), dt=900.0
    )
    jd1, jd2 = jsteppers.non_negative_sphum(sphum, dQ1, dQ2, dt=900.0)
    np.testing.assert_array_equal(d1.numpy(), np.asarray(jd1))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jd2))
    assert float(d2[0]) == pytest.approx(-1e-6)
    assert sphum[1] + float(d2[1]) * 900.0 >= -1e-18
    from fv3net_tpu_torch.constants import CP_AIR, LATENT_HEAT_VAPORIZATION

    lhs = CP_AIR * d1.numpy() + LATENT_HEAT_VAPORIZATION * d2.numpy()
    rhs = CP_AIR * dQ1 + LATENT_HEAT_VAPORIZATION * dQ2
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_renaming_and_multi_model_adapters():
    base = ConstantTendencyModel()
    renamed = tsteppers.RenamingAdapter(
        base, rename_in={"T_renamed": names.TEMP, "q_renamed": names.SPHUM}
    )
    assert "T_renamed" in renamed.input_variables
    q = Quantity(np.zeros((2, 2)), ("y", "x"), "K")
    out = renamed.predict({"T_renamed": q, "q_renamed": q})
    assert "dQ1" in out
    multi = tsteppers.MultiModelAdapter([base])
    assert set(multi.input_variables) == set(base.input_variables)


def test_nudging_stepper(models):
    out = {}
    for pkg in PKGS:
        wrapper, _, steppers, derived, _ = PKGS[pkg]
        state = derived.DerivedModelState(wrapper)
        target = state[names.TEMP]
        ref_state = {names.TEMP: target.with_data(target.values + 2.0)}
        stepper = steppers.PureNudger(
            steppers.NudgingConfig(timescale_hours={names.TEMP: 2.0}),
            lambda time: ref_state,
        )
        tendencies, diags, _ = stepper(state.time, state)
        out[pkg] = tendencies["dQ1"].values
        np.testing.assert_allclose(out[pkg], 2.0 / 7200.0, rtol=1e-10)
        assert "air_temperature_tendency_due_to_nudging" in diags
    np.testing.assert_array_equal(out["torch"], out["jax"])


def test_prescriber_and_combined(models):
    _, tm = models
    state = tderived.MergedState(tderived.DerivedModelState(twrapper))
    state.overlay[names.MASK] = Quantity(
        np.zeros((6, tm.n, tm.n)), ("tile", "y", "x"), ""
    )
    new_tsfc = Quantity(
        np.full((6, tm.n, tm.n), 300.0), ("tile", "y", "x"), "degK"
    )
    presc = tsteppers.Prescriber(
        tsteppers.PrescriberConfig(variables=[names.TSFC]),
        lambda t: {names.TSFC: new_tsfc},
    )
    _, _, updates = presc(state.time, state)
    np.testing.assert_allclose(updates[names.TSFC].values, 300.0)
    combined = tsteppers.CombinedStepper(
        [presc, tsteppers.PureMLStepper(ConstantTendencyModel(), dt=DT)]
    )
    t, d, u = combined(state.time, state)
    assert "dQ1" in t and names.TSFC in u
    assert isinstance(t["dQ1"].data, torch.Tensor)
    with pytest.raises(ValueError, match="collision"):
        tsteppers.CombinedStepper([presc, presc])(state.time, state)


def test_metrics(models):
    got = tmetrics.compute_metrics(
        tderived.DerivedModelState(twrapper), models[1].area
    )
    want = jmetrics.compute_metrics(
        jderived.DerivedModelState(jwrapper), models[0].area
    )
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-14), k
    assert 9.0e4 < got["area_mean_surface_pressure"] < 1.1e5
    tmetrics.log_metrics(got, datetime.datetime(2016, 8, 1))
    with pytest.raises(ValueError, match="finite"):
        tmetrics.validate_metrics({"x": float("nan")})


def test_add_tendency_fills_nans(models):
    state = tderived.DerivedModelState(twrapper)
    t = state[names.TEMP]
    tend = {"dQ1": t.with_data(np.full_like(t.values, np.nan))}
    filled, diags = tloop.fillna_tendencies(tend)
    assert float(diags["dQ1_filled_frac"].values) == 1.0
    out = tloop.add_tendency(state, filled, DT)
    np.testing.assert_allclose(out[names.TEMP].values, t.values)
    # a tensor tendency fills on its device, with its own filled fraction
    half = t.data.clone()
    half[:3] = float("nan")
    filled, diags = tloop.fillna_tendencies({"dQ1": t.with_data(half)})
    assert isinstance(filled["dQ1"].data, torch.Tensor)
    assert float(diags["dQ1_filled_frac"].data) == 0.5
    assert not bool(torch.isnan(filled["dQ1"].data).any())


def test_coupling_hot_path_stays_on_device(models):
    """One TimeLoop step carries the monitored tendencies and the
    tendency application as tensors end to end; host copies only at
    diagnostic sinks (.values)."""
    state = tderived.DerivedModelState(twrapper)
    stepper = tsteppers.PureMLStepper(ConstantTendencyModel(), dt=DT)
    loop = tloop.TimeLoop(
        twrapper, state, dt=DT, postphysics_stepper=stepper, n_steps=1
    )
    _, diags = next(iter(loop))
    for key in ("tendency_of_air_temperature_due_to_fv3_dynamics",
                "storage_of_air_temperature_path_due_to_fv3_dynamics",
                "tendency_of_air_temperature_due_to_python",
                "water_vapor_path", "dQ1_filled_frac"):
        assert isinstance(diags[key].data, torch.Tensor), key
    st = twrapper.get_state([names.TEMP, names.DELP])
    assert isinstance(st[names.DELP].data, torch.Tensor)
    assert isinstance(st[names.TEMP].data, torch.Tensor)
    report = loop.log_timings()
    assert {k for k in report if not k.startswith("host:")} == {
        "mainloop", "tracers", "dynamics", "prephysics", "physics",
        "postphysics",
    }
    # beside them the process's host spans of set-up (the model's build)
    assert {"host:setup.grid", "host:setup.metrics"} <= set(report)


def test_simple_suite_physics_on_device(models):
    """The default suite's apply_physics (saturation adjustment) keeps
    the state and the precipitation in tensors on the model's device."""
    assert twrapper.get_model().config.do_sat_adj
    twrapper.apply_physics()
    st = twrapper.get_state([names.SPHUM])
    assert isinstance(st[names.SPHUM].data, torch.Tensor)
    mdl = twrapper.get_model()
    assert isinstance(mdl.precip_rate, torch.Tensor)
    assert isinstance(mdl.total_precip, torch.Tensor)
    assert mdl.total_precip.dtype == torch.float64


def test_gfs_emulation_hooks_match_jax():
    """The GFS suite's emulation-hook seam: the hooks see the same keys
    and arrays in both packages, a substituted total_precipitation_output
    takes effect, and the state after apply_physics agrees."""
    kw = dict(physics_suite="gfs", do_radiation=False)
    seen, after = {}, {}
    for pkg in PKGS:
        mdl = _init(pkg, **kw)
        wrapper = PKGS[pkg][0]
        _moisten(wrapper, mdl, seed=2)
        got = seen[pkg] = {}

        def gscond_hook(sd, got=got):
            got["gscond"] = {k: np.asarray(v) for k, v in sd.items()
                             if k != "time"}

        def micro_hook(sd, got=got):
            got["micro"] = sorted(sd)
            sd["total_precipitation_output"] = np.zeros_like(
                sd["total_precipitation"])
            sd["air_temperature_output"] = (
                np.asarray(sd["air_temperature_after_precpd"]) + 0.5)

        def store_hook(sd, got=got):
            got["stored"] = len(sd)

        mdl.emulation_hooks = (gscond_hook, micro_hook, store_hook)
        wrapper.apply_physics()
        after[pkg] = {
            k: wrapper.get_state([k])[k].values
            for k in (names.TEMP, names.SPHUM, names.CLOUD, names.X_WIND,
                      names.TOTAL_PRECIP)
        }
        wrapper.cleanup()
    assert seen["torch"]["micro"] == seen["jax"]["micro"]
    assert seen["torch"]["stored"] == seen["jax"]["stored"]
    assert set(seen["torch"]["gscond"]) == set(seen["jax"]["gscond"])
    for k, want in seen["jax"]["gscond"].items():
        assert_close_scaled(seen["torch"]["gscond"][k], want, RTOL, name=k)
    for k, want in after["jax"].items():
        assert_close_scaled(after["torch"][k], want, RTOL, name=k)


# --- two TimeLoop steps in three configurations --------------------------


def _moisten(wrapper, mdl, seed):
    """Seeded temperature noise and humidity at a seeded relative
    humidity per column, up to 10% supersaturated (so that the simple
    suite condenses and rains), set through the wrapper's API in either
    package."""
    rng = np.random.RandomState(seed)
    st = wrapper.get_state([names.TEMP, names.DELP])
    t = st[names.TEMP].values + rng.randn(6, NZ, N, N)
    p = np.cumsum(st[names.DELP].values, axis=1) + mdl.config.ptop
    es = 611.2 * np.exp(17.67 * (t - 273.15) / (t - 29.65))
    qs = 0.622 * es / (p - 0.378 * es)
    rh = rng.uniform(0.5, 1.1, size=(6, 1, N, N))
    q = np.minimum(rh * qs, 0.02)
    wrapper.set_state({
        names.SPHUM: st[names.TEMP].with_data(q),
        names.TEMP: st[names.TEMP].with_data(t),
    })


def _loop(pkg, suite):
    """Two TimeLoop steps of `suite` in package `pkg`: the state fields,
    total precipitation and every diagnostic of each step, as numpy."""
    wrapper, loop_mod, steppers, derived, Q = PKGS[pkg]
    kw = {
        "simple": dict(),
        "held_suarez": dict(do_held_suarez=True, physics_suite="none"),
        "gfs": dict(physics_suite="gfs", do_radiation=True),
    }[suite]
    mdl = _init(pkg, **kw)
    _moisten(wrapper, mdl, seed=1)
    state = derived.DerivedModelState(wrapper)
    pre, post = [], None
    if suite == "simple":
        post = steppers.PureMLStepper(
            ConstantTendencyModel(dq1=1e-5, dq2=-2e-9), dt=DT
        )
    elif suite == "held_suarez":
        target = state[names.TEMP].values + 2.0
        post = steppers.PureNudger(
            steppers.NudgingConfig(timescale_hours={names.TEMP: 3.0}),
            lambda time: {names.TEMP: Q(target, ("tile", "z", "y", "x"))},
        )
    else:
        state = derived.MergedState(state)
        state.overlay[names.MASK] = Q(
            (np.arange(6 * N * N).reshape(6, N, N) % 3 == 0).astype(float),
            ("tile", "y", "x"), "",
        )
        sst = Q(np.full((6, N, N), 295.0), ("tile", "y", "x"), "degK")
        pre = [steppers.Prescriber(
            steppers.PrescriberConfig(variables=[names.TSFC]),
            lambda time: {names.TSFC: sst},
        )]
    loop = loop_mod.TimeLoop(
        wrapper, state, dt=DT, prephysics_steppers=pre,
        postphysics_stepper=post, n_steps=2,
    )
    steps = []
    for time, diags in loop:
        snap = {k: _np(getattr(mdl.state, k))
                for k in ("delp", "pt", "u", "v", "q")}
        snap["total_precip"] = _np(mdl.total_precip)
        snap["tsfc"] = np.array(mdl.tsfc)
        steps.append((time, snap, {k: v.values for k, v in diags.items()}))
    assert mdl.state.w is None
    return steps


@pytest.mark.parametrize("suite", ["simple", "held_suarez", "gfs"])
def test_two_time_loop_steps_match_jax(suite):
    want = _loop("jax", suite)
    got = _loop("torch", suite)
    for (tt, tsnap, tdiags), (jt, jsnap, jdiags) in zip(got, want):
        assert tt == jt
        for k, w in jsnap.items():
            assert_close_scaled(tsnap[k], w, RTOL, name=f"{suite} {k}")
        assert set(tdiags) == set(jdiags)
        for k, w in jdiags.items():
            assert_close_scaled(tdiags[k], w, RTOL, name=f"{suite} {k}")
    # each configuration moved the state it is meant to move
    (_, s0, d0), (_, s1, d1) = got
    if suite == "simple":
        np.testing.assert_allclose(
            d1["tendency_of_air_temperature_due_to_python"].mean(), 1e-5,
            rtol=0.3,
        )
    if suite == "held_suarez":
        assert np.abs(s1["u"]).max() > 0.0
        assert "air_temperature_tendency_due_to_nudging" in d1
    if suite == "gfs":
        np.testing.assert_array_equal(
            s1["tsfc"], np.where(
                (np.arange(6 * N * N).reshape(6, N, N) % 3 == 0), 288.0,
                295.0,
            )
        )
    assert jax.config.jax_enable_x64


# --- the physics and host modules the runtime reads ------------------------


def test_held_suarez_tendencies_match_jax():
    from fv3net_tpu.physics.simple import held_suarez_tendencies as jhs
    from fv3net_tpu_torch.physics.simple import held_suarez_tendencies

    rng = np.random.RandomState(6)
    temp = 250.0 + 30.0 * rng.rand(6, NZ, N, N)
    u = 10.0 * rng.randn(6, NZ, N + 1, N)
    v = 10.0 * rng.randn(6, NZ, N, N + 1)
    pe = np.cumsum(np.concatenate(
        [np.full((6, 1, N, N), 300.0), 1e5 / NZ * (0.5 + rng.rand(
            6, NZ, N, N))], axis=1), axis=1)
    lat = np.pi * (rng.rand(6, N, N) - 0.5)
    want = jhs(temp, u, v, pe, lat, DT)
    got = held_suarez_tendencies(
        *(torch.as_tensor(a) for a in (temp, u, v, pe, lat)), DT)
    for name, g, w in zip(("dT", "du", "dv"), got, want):
        assert_close_scaled(g.numpy(), np.asarray(w), 1e-14, name=name)


THERMO = {
    "pressure_interface": lambda m, dp, t, q: m.pressure_interface(dp),
    "pressure_at_midpoint_log":
        lambda m, dp, t, q: m.pressure_at_midpoint_log(dp),
    "surface_pressure_from_delp":
        lambda m, dp, t, q: m.surface_pressure_from_delp(dp),
    "mass_integrate": lambda m, dp, t, q: m.mass_integrate(q, dp),
    "relative_humidity_from_pressure":
        lambda m, dp, t, q: m.relative_humidity_from_pressure(
            t, q, m.pressure_at_midpoint_log(dp)),
    "potential_temperature": lambda m, dp, t, q: m.potential_temperature(
        m.pressure_at_midpoint_log(dp), t),
    "virtual_temperature": lambda m, dp, t, q: m.virtual_temperature(t, q),
    "height_at_interface": lambda m, dp, t, q: m.height_at_interface(
        -dp / 12.0, 100.0 * t[:, 0]),
    "liquid_ice_temperature":
        lambda m, dp, t, q: m.liquid_ice_temperature(t, q),
}


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("fn", sorted(THERMO))
def test_thermo_matches_jax(fn, kind):
    """utils/thermo on numpy arrays and on tensors against the JAX
    package's utils/thermo."""
    from fv3net_tpu.utils import thermo as jthermo
    from fv3net_tpu_torch.utils import thermo as tthermo

    rng = np.random.RandomState(7)
    arrays = (1000.0 + 500.0 * rng.rand(6, NZ, N, N),
              220.0 + 80.0 * rng.rand(6, NZ, N, N),
              0.02 * rng.rand(6, NZ, N, N))
    want = np.asarray(THERMO[fn](jthermo, *arrays))
    args = arrays if kind == "numpy" else tuple(
        torch.as_tensor(a) for a in arrays)
    got = THERMO[fn](tthermo, *args)
    assert isinstance(got, torch.Tensor) == (kind == "tensor")
    assert_close_scaled(_np(got), want, 1e-14, name=fn)


DERIVED = ("pressure", "pressure_at_interface", "surface_pressure",
           "relative_humidity", "potential_temperature",
           "virtual_temperature", "total_water", "column_integrated_water",
           "water_vapor_path", "cos_zenith_angle", "internal_energy",
           "pQ1", "eastward_wind")


def test_derived_mapping_matches_jax():
    """The registered derived variables of runtime/derived_state over
    each package's moist model state."""
    out = {}
    for pkg in PKGS:
        wrapper, _, _, derived, _ = PKGS[pkg]
        _init(pkg)
        _moisten(wrapper, wrapper.get_model(), seed=4)
        dm = derived.DerivedMapping(derived.DerivedModelState(wrapper))
        out[pkg] = {k: dm[k] for k in DERIVED}
    for k in DERIVED:
        got, want = out["torch"][k], out["jax"][k]
        assert got.dims == want.dims, k
        assert_close_scaled(got.values, want.values, 1e-13, name=k)


def test_rotate_matches_jax():
    from fv3net_tpu.grid import CubedSphereGrid as JGrid
    from fv3net_tpu.utils import rotate as jrotate
    from fv3net_tpu_torch.grid import CubedSphereGrid as TGrid
    from fv3net_tpu_torch.utils import rotate as trotate

    got = trotate.wind_rotation_matrix(TGrid.make(N, halo=3))
    want = jrotate.wind_rotation_matrix(JGrid.make(N, halo=3))
    rng = np.random.RandomState(8)
    u, v = rng.randn(6, NZ, N + 1, N), rng.randn(6, NZ, N, N + 1)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
    for g, w in zip(trotate.center_and_rotate_xy_winds(got, u, v),
                    jrotate.center_and_rotate_xy_winds(want, u, v)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_tendency_prescriber_matches_jax():
    """TendencyPrescriber around apply_physics: the model's temperature
    tendency is replaced by the prescribed one in both packages."""
    out = {}
    for pkg in PKGS:
        wrapper, _, steppers, derived, Q = PKGS[pkg]
        _init(pkg)
        _moisten(wrapper, wrapper.get_model(), seed=5)
        state = derived.DerivedModelState(wrapper)
        tend = Q(np.full((6, NZ, N, N), 2e-4), ("tile", "z", "y", "x"))
        before = state[names.TEMP].values
        presc = steppers.TendencyPrescriber(
            steppers.TendencyPrescriberConfig(
                variables={names.TEMP: "prescribed_dQ1"}),
            state, DT, lambda time: {"prescribed_dQ1": tend},
        )
        diags = presc(wrapper.apply_physics)()
        assert "tendency_of_air_temperature_due_to_tendency_prescriber" \
            in diags
        out[pkg] = state[names.TEMP].values
        np.testing.assert_allclose(out[pkg] - before, 2e-4 * DT, rtol=1e-9)
    assert_close_scaled(out["torch"], out["jax"], 1e-14, name="T")
