"""The nudged run of fv3net_tpu_torch against the JAX package's (the call
stack of tests/test_nudging_e2e.py): restart snapshots -> the
time-interpolated reference state (``runtime/nudging.py``) -> PureNudger
in the TimeLoop of the slice's configuration (nonhydrostatic, GFS suite
with gray radiation and GFDL microphysics over six advected species,
initialised from Fortran restarts) -> ``{var}_tendency_due_to_nudging``
written to zarr -> ``open_nudge_to_fine`` -> ``batches_from_mapper``.
C6 x 8, float64 on the CPU, the same restart files for both packages."""

import datetime

import numpy as np
import pytest
import torch

from fv3net_tpu import data as jdata
from fv3net_tpu import wrapper as jwrapper
from fv3net_tpu.io import restarts as jrst
from fv3net_tpu.io.zarr_lite import ZarrLiteStore as JStore
from fv3net_tpu.runtime import derived_state as jderived
from fv3net_tpu.runtime import loop as jloop
from fv3net_tpu.runtime import nudging as jnudging
from fv3net_tpu.runtime import steppers as jsteppers
from fv3net_tpu.util.quantity import Quantity as JQuantity
from fv3net_tpu_torch import data as tdata
from fv3net_tpu_torch import wrapper as twrapper
from fv3net_tpu_torch.io.zarr_lite import ZarrLiteStore as TStore
from fv3net_tpu_torch.runtime import derived_state as tderived
from fv3net_tpu_torch.runtime import loop as tloop
from fv3net_tpu_torch.runtime import names
from fv3net_tpu_torch.runtime import nudging as tnudging
from fv3net_tpu_torch.runtime import steppers as tsteppers
from fv3net_tpu_torch.util.quantity import Quantity
from torch_parity import assert_close_scaled, benchmark_like_state

torch.set_num_threads(1)

N, NZ, DT, PTOP = 6, 8, 900.0, 300.0
T0 = datetime.datetime(2016, 8, 1, 0, 0, 0)
STEPS = 2
# float64 in both packages.  The nonhydrostatic dycore agrees to ~1e-13
# of each field over a dt (tests/test_torch_dycore.py) and the physics
# to roundoff (tests/test_torch_gfdl.py); as in
# tests/test_torch_runtime.py, 1e-9 of each field's magnitude
RTOL = 1e-9
PKGS = {
    "jax": (jwrapper, jloop, jsteppers, jderived, jnudging, jdata, JStore,
            JQuantity),
    "torch": (twrapper, tloop, tsteppers, tderived, tnudging, tdata, TStore,
              Quantity),
}
TEND = [f"{names.TEMP}_tendency_due_to_nudging",
        f"{names.SPHUM}_tendency_due_to_nudging"]
DIMS = ("tile", "z", "y", "x")


def moist_restart_state(n, nz, seed=0):
    """A seeded moist state for the restart files, as numpy float64 in
    the wrapper's tracer order (sphum, liq_wat, ice_wat, rainwat,
    snowwat, graupel): pt noise and random winds on the hybrid
    coordinate, humidity at a seeded relative humidity per column up to
    1.1, cloud liquid, and ice, rain and snow aloft."""
    from fv3net_tpu_torch.constants import KAPPA, REFERENCE_SURFACE_PRESSURE
    from fv3net_tpu_torch.physics.gfs import qsat

    delp, pt, u, v, _ = benchmark_like_state(n, nz, seed=seed)
    rng = np.random.RandomState(seed + 7)
    pe = PTOP + np.concatenate(
        [np.zeros_like(delp[:, :1]), np.cumsum(delp, axis=1)], axis=1)
    p = 0.5 * (pe[:, 1:] + pe[:, :-1])
    temp = pt * (p / REFERENCE_SURFACE_PRESSURE) ** KAPPA
    qs = qsat(torch.as_tensor(temp), torch.as_tensor(p)).numpy()
    rh = rng.uniform(0.5, 1.1, size=(6, 1, n, n))
    q = np.zeros((6, 6, nz, n, n))
    q[0] = np.minimum(rh * (p / p[:, -1:]) ** 3 * qs, 0.02)
    q[1] = 2e-4 * rng.rand(6, nz, n, n)
    cold = (temp < 260.0).astype(float)
    q[2] = 1e-4 * rng.rand(6, nz, n, n) * cold
    q[3] = 2e-4 * rng.rand(6, nz, n, n) * (p > 3e4)
    q[4] = 1e-4 * rng.rand(6, nz, n, n) * cold
    return delp, pt, u, v, q


@pytest.fixture(scope="module")
def restart_dir(tmp_path_factory):
    """INPUT/ of the slice's state (the JAX package's write_restarts) and
    two reference snapshots at T0 and T0 + 1 h: the initial model's
    temperature + 3 K and humidity + 1e-4 (the JAX package's model
    initialised from INPUT/), as tests/test_nudging_e2e.py."""
    from fv3net_tpu.dycore.hydro import DycoreState

    base = tmp_path_factory.mktemp("nudged")
    delp, pt, u, v, q = moist_restart_state(N, NZ)
    phis = np.zeros((6, N, N))
    fields = jrst.restarts_from_state(DycoreState(delp, pt, u, v, q), phis,
                                      PTOP)
    jrst.write_restarts(fields, str(base / "run"), time=T0, subdir="INPUT")
    jwrapper.initialize(config("jax", str(base / "run")))
    st = jwrapper.get_state([names.TEMP, names.SPHUM])
    for hours in (0, 1):
        label = jnudging.time_to_label(T0 + datetime.timedelta(hours=hours))
        jrst.write_restarts(
            {"T": JQuantity(st[names.TEMP].values + 3.0, DIMS, "K"),
             "sphum": JQuantity(st[names.SPHUM].values + 1e-4, DIMS,
                                "kg/kg")},
            str(base / "reference"), subdir=label)
    return base


def config(pkg, rundir):
    return PKGS[pkg][0].ModelConfig(
        npx=N + 1, npz=NZ, dt_atmos=DT, n_split=4, hydrostatic=False,
        physics_suite="gfs", do_radiation=True, microphysics_scheme="gfdl",
        prognostic_mp_tracers=True, dtype="float64", restart_dir=rundir)


def nudged_run(pkg, base, outdir):
    """STEPS TimeLoop steps of the slice's configuration with the nudger
    from the snapshots; the state, total precipitation and diagnostics of
    each step as numpy, the two stores written as the JAX package's
    nudged-run test writes them, the mapper and the batches."""
    wrapper, loop_mod, steppers, derived, nudging, data, Store, Q = PKGS[pkg]
    if pkg == "torch":
        wrapper.initialize(config(pkg, str(base / "run")), device="cpu")
    else:
        wrapper.initialize(config(pkg, str(base / "run")))
    mdl = wrapper.get_model()
    assert mdl.time == T0
    nudger = nudging.nudger_from_config(steppers.NudgingConfig(
        timescale_hours={names.TEMP: 3.0, names.SPHUM: 3.0},
        restarts_path=str(base / "reference")))
    state = derived.DerivedModelState(wrapper)
    loop = loop_mod.TimeLoop(wrapper, state, dt=DT,
                             postphysics_stepper=nudger, n_steps=STEPS)
    steps, times = [], []
    rows = {v: [] for v in [names.TEMP, names.SPHUM] + TEND}
    for time, diags in loop:
        snap = {k: np.array(getattr(mdl.state, k))
                for k in ("delp", "pt", "u", "v", "q", "w", "delz")}
        snap["total_precip"] = np.array(mdl.total_precip)
        steps.append((time, snap, {k: np.array(v.values)
                                   for k, v in diags.items()}))
        times.append(nudging.time_to_label(time))
        for v in (names.TEMP, names.SPHUM):
            rows[v].append(np.array(state[v].values))
        for v in TEND:
            rows[v].append(np.asarray(diags[v].values))
    for zarr, group in (("state_after_timestep.zarr", [names.TEMP,
                                                        names.SPHUM]),
                        ("nudging_tendencies.zarr", TEND)):
        store = Store(str(outdir / zarr))
        for v in group:
            arr = np.stack(rows[v]).astype(np.float32)
            store.create_array(v, shape=arr.shape,
                               chunks=(1,) + arr.shape[1:],
                               dtype=np.float32, dims=("time",) + DIMS)
            store.write_full(v, arr)
    mapper = data.open_nudge_to_fine(str(outdir))
    batches = data.batches_from_mapper(
        "open_nudge_to_fine", {"url": str(outdir)},
        variable_names=[names.TEMP, "dQ1", "dQ2"])
    return steps, rows, mapper, batches


@pytest.fixture(scope="module")
def runs(restart_dir, tmp_path_factory):
    return {pkg: nudged_run(pkg, restart_dir,
                            tmp_path_factory.mktemp(f"out_{pkg}"))
            for pkg in PKGS}


def test_reference_state_interpolation_matches_jax(restart_dir):
    cfg = dict(timescale_hours={names.TEMP: 3.0, names.SPHUM: 3.0},
               restarts_path=str(restart_dir / "reference"))
    tget = tnudging.setup_get_reference_state(tsteppers.NudgingConfig(**cfg))
    jget = jnudging.setup_get_reference_state(jsteppers.NudgingConfig(**cfg))
    (fields,) = jrst.open_restarts(
        str(restart_dir / "reference" / jnudging.time_to_label(T0))).values()
    for minutes in (0, 15, 30, 60):
        time = T0 + datetime.timedelta(minutes=minutes)
        got, want = tget(time), jget(time)
        assert set(got) == set(want) == {names.TEMP, names.SPHUM}
        for k, w in want.items():
            assert got[k].dims == w.dims
            np.testing.assert_array_equal(got[k].values, w.values, k)
        # both snapshots hold the same state: exact at the snapshots,
        # to 1e-12 of it between them (the two weights' roundoff)
        exact = {names.TEMP: fields["T"].values,
                 names.SPHUM: fields["sphum"].values}
        for k, x in exact.items():
            if minutes in (0, 60):
                np.testing.assert_array_equal(got[k].values, x)
            else:
                np.testing.assert_allclose(got[k].values, x, rtol=1e-12)
    for outside in (T0 - datetime.timedelta(minutes=1),
                    T0 + datetime.timedelta(minutes=61)):
        with pytest.raises(ValueError):
            tget(outside)
    label = tnudging.time_to_label(T0 + datetime.timedelta(minutes=15))
    assert label == "20160801.001500"
    assert tnudging.label_to_time(label) == jnudging.label_to_time(label)


def test_two_nudged_time_loop_steps_match_jax(runs):
    got, want = runs["torch"][0], runs["jax"][0]
    assert len(got) == len(want) == STEPS
    for (tt, tsnap, tdiags), (jt, jsnap, jdiags) in zip(got, want):
        assert tt == jt
        for k, w in jsnap.items():
            assert_close_scaled(tsnap[k], w, RTOL, name=f"state {k}")
        assert set(tdiags) == set(jdiags)
        for k, w in jdiags.items():
            assert_close_scaled(tdiags[k], w, RTOL, name=f"diag {k}")
    (t1, s1, d1) = got[-1]
    assert t1 == T0 + datetime.timedelta(seconds=STEPS * DT)
    # the GFDL scheme rained, the hydrometeors stayed non-negative and
    # the nudging warmed the state toward the reference
    assert s1["total_precip"].max() > 0.0
    assert s1["q"].shape[0] == 6
    assert s1["q"][1:].min() >= -1e-12
    tend = d1[TEND[0]]
    assert np.nanmean(tend) > 0.0
    assert np.nanmax(np.abs(tend)) < 10.0 / (3 * 3600.0)


def test_nudge_to_fine_mapper_and_batches_match_jax(runs):
    _, trows, tmapper, tbatches = runs["torch"]
    _, jrows, jmapper, jbatches = runs["jax"]
    assert len(tmapper) == len(jmapper) == STEPS
    assert sorted(tmapper.keys()) == sorted(jmapper.keys())
    for key in jmapper.keys():
        t, j = tmapper[key], jmapper[key]
        assert set(t) == set(j) >= {"dQ1", "dQ2", names.TEMP}
        for k in j:
            assert t[k].dims == j[k].dims, k
            assert_close_scaled(t[k].values, j[k].values, RTOL, name=k)
    first = tmapper[sorted(tmapper.keys())[0]]
    np.testing.assert_array_equal(first["dQ1"].values,
                                  trows[TEND[0]][0].astype(np.float32))
    assert len(tbatches) == len(jbatches) == STEPS
    for tb, jb in zip(tbatches, jbatches):
        assert set(tb) == set(jb) == {names.TEMP, "dQ1", "dQ2"}
        for k in jb:
            assert_close_scaled(tb[k].values, jb[k].values, RTOL, name=k)


def test_nudged_case_writes_initializes_and_steps(tmp_path):
    """runtime.nudged_case (the case chip_smoke.py and step_profile drive
    on the card) at C6 x 63 on the CPU: the wrapper starts from its
    INPUT/ with six species and the restart time, a second run of the
    same case reads the same files, and one nudged step warms the state
    toward the snapshots."""
    from fv3net_tpu_torch.io import restarts
    from fv3net_tpu_torch.runtime import nudged_case

    wm, nudger = nudged_case.initialize(6, "cpu", str(tmp_path), "float64")
    mdl = wm.get_model()
    assert mdl.time == nudged_case.T0 and mdl.state.q.shape[0] == 6
    assert not mdl.config.hydrostatic and mdl.state.delz is not None
    want, _ = restarts.state_from_restarts(restarts.open_restarts(
        str(tmp_path / "run"))["INPUT"], nudged_case.PTOP)
    for k, w in want._asdict().items():
        np.testing.assert_array_equal(getattr(mdl.state, k).numpy(), w, k)
    assert all(float(want.q[i].max()) > 0.0 for i in range(6))
    ref = nudger.get_reference_state(nudged_case.T0)
    t0 = wm.get_state([names.TEMP])[names.TEMP].values
    np.testing.assert_allclose(ref[names.TEMP].values, t0 + 3.0, rtol=1e-15)
    wm2, _ = nudged_case.initialize(6, "cpu", str(tmp_path), "float32")
    np.testing.assert_array_equal(wm2.get_model().state.delp.numpy(),
                                  want.delp)
    wm, nudger = nudged_case.initialize(6, "cpu", str(tmp_path), "float64")
    loop = tloop.TimeLoop(wm, tderived.DerivedModelState(wm), DT,
                          postphysics_stepper=nudger, n_steps=1)
    (time, diags), = list(loop)
    assert time == nudged_case.T0 + datetime.timedelta(seconds=DT)
    assert np.mean(diags[TEND[0]].values) > 0.0
    assert float(wm.get_model().total_precip.max()) > 0.0
