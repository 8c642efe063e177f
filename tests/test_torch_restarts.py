"""Fortran restarts in fv3net_tpu_torch against the JAX package: the
NetCDF classic codec (``io/netcdf3.py``, the same bytes for versions 1
and 2, and each package reads the other's files), the restart layer
(``io/restarts.py``: write, open, convert, bit for bit) and
``wrapper.initialize(ModelConfig(restart_dir=...))`` (state, phis and
time bit for bit, hydrostatic and nonhydrostatic, a two-species restart
padded to the six species of the GFDL tracer set); float64 on the CPU."""

import datetime
import os

import numpy as np
import pytest
import torch

from fv3net_tpu import wrapper as jwrapper
from fv3net_tpu.io import netcdf3 as jnc
from fv3net_tpu.io import restarts as jrst
from fv3net_tpu.util.quantity import Quantity as JQuantity
from fv3net_tpu_torch import wrapper as twrapper
from fv3net_tpu_torch.io import netcdf3 as tnc
from fv3net_tpu_torch.io import restarts as trst
from torch_parity import benchmark_like_state

torch.set_num_threads(1)

N, NZ, PTOP = 6, 8, 300.0
T0 = datetime.datetime(2016, 8, 1, 3, 0, 0)


def _dataset(nc):
    """A dataset with a record variable, a float32 record variable, a
    fixed int32 variable, a char attribute and an int attribute."""
    rng = np.random.RandomState(0)
    dims = {"Time": None, "zaxis_1": 4, "yaxis_1": 3, "xaxis_1": 3}
    variables = {
        "T": nc.Variable(rng.rand(2, 4, 3, 3),
                         ("Time", "zaxis_1", "yaxis_1", "xaxis_1"),
                         {"units": "K", "long_name": "temperature"}),
        "phis": nc.Variable(rng.rand(2, 3, 3).astype(np.float32),
                            ("Time", "yaxis_1", "xaxis_1"),
                            {"units": "m**2/s**2"}),
        "counts": nc.Variable(np.arange(12, dtype=np.int32).reshape(4, 3),
                              ("zaxis_1", "yaxis_1"), {}),
    }
    return nc.Dataset(dims, variables, {"title": "sample", "n": 3})


def _same_dataset(a, b):
    assert a.dimensions == b.dimensions
    assert dict(a.attrs) == dict(b.attrs)
    assert list(a.variables) == list(b.variables)
    for name, var in a.variables.items():
        other = b.variables[name]
        assert var.dims == other.dims and dict(var.attrs) == dict(other.attrs)
        assert var.data.dtype == other.data.dtype
        np.testing.assert_array_equal(var.data, other.data)


@pytest.mark.parametrize("version", [1, 2])
def test_netcdf3_bytes_equal_and_cross_read(tmp_path, version):
    want = jnc.dumps(_dataset(jnc), version=version)
    got = tnc.dumps(_dataset(tnc), version=version)
    assert got == want
    jpath, tpath = str(tmp_path / "jax.nc"), str(tmp_path / "torch.nc")
    jnc.write(jpath, _dataset(jnc), version=version)
    tnc.write(tpath, _dataset(tnc), version=version)
    _same_dataset(tnc.read(jpath), jnc.read(jpath))
    _same_dataset(jnc.read(tpath), tnc.read(tpath))
    _same_dataset(tnc.loads(want), jnc.loads(got))


def _state(species=2, nonhydrostatic=True, seed=0):
    """A seeded moist state (numpy float64; the JAX package's
    DycoreState) with `species` tracers and, when asked, w and delz."""
    from fv3net_tpu.dycore.hydro import DycoreState

    delp, pt, u, v, q = benchmark_like_state(N, NZ, seed=seed)
    rng = np.random.RandomState(seed + 1)
    q = np.concatenate([q] + [1e-4 * rng.rand(*q.shape)
                              for _ in range(species - 1)])
    w = delz = None
    if nonhydrostatic:
        w = 0.1 * rng.randn(*delp.shape)
        delz = -(30.0 + delp * 0.1 * (1.0 + 0.01 * rng.rand(*delp.shape)))
    return DycoreState(delp, pt, u, v, q, w, delz)


def _write(rundir, state, subdir="INPUT", time=T0, extra=True):
    """The JAX package's write_restarts of `state` with seeded phis and a
    surface field, and coupler.res at `time`."""
    phis = 100.0 * np.random.RandomState(3).rand(6, N, N)
    fields = jrst.restarts_from_state(state, phis, PTOP)
    if extra:
        fields["tsea"] = JQuantity(
            290 + np.random.RandomState(4).rand(6, N, N),
            ("tile", "grid_yt", "grid_xt"), "K")
    jrst.write_restarts(fields, str(rundir), time=time, subdir=subdir)
    return fields


def test_write_open_and_convert_match_jax_bit_for_bit(tmp_path):
    state = _state(species=6)
    jfields = _write(tmp_path / "jax", state)
    # the port writes the same files from the same fields
    tfields = trst.restarts_from_state(state, jfields["phis"].values, PTOP)
    for k, q in tfields.items():
        np.testing.assert_array_equal(q.values, jfields[k].values, k)
        assert q.dims == jfields[k].dims and q.units == jfields[k].units
    tfields["tsea"] = jfields["tsea"]
    trst.write_restarts(tfields, str(tmp_path / "torch"), time=T0,
                        subdir="INPUT")
    files = sorted(os.listdir(tmp_path / "jax" / "INPUT"))
    assert files == sorted(os.listdir(tmp_path / "torch" / "INPUT"))
    assert len(files) == 19  # 3 categories x 6 tiles + coupler.res
    for f in files:
        with open(tmp_path / "jax" / "INPUT" / f, "rb") as a, \
                open(tmp_path / "torch" / "INPUT" / f, "rb") as b:
            assert a.read() == b.read(), f
    assert (list(trst.yield_restart_files(str(tmp_path / "jax")))
            == [(p, c, t, s.replace("torch", "jax")) for p, c, t, s in
                trst.yield_restart_files(str(tmp_path / "torch"))])
    want = jrst.open_restarts(str(tmp_path / "jax"))
    got = trst.open_restarts(str(tmp_path / "jax"))
    assert list(got) == list(want) == ["INPUT"]
    for k, q in want["INPUT"].items():
        g = got["INPUT"][k]
        assert g.dims == q.dims and g.units == q.units, k
        np.testing.assert_array_equal(g.values, q.values, k)
    wst, wphis = jrst.state_from_restarts(want["INPUT"], PTOP)
    gst, gphis = trst.state_from_restarts(got["INPUT"], PTOP)
    for k, w in wst._asdict().items():
        g = getattr(gst, k)
        assert g.dtype == np.float32 == w.dtype, k
        np.testing.assert_array_equal(g, w, k)
    np.testing.assert_array_equal(gphis, wphis)
    path = os.path.join(tmp_path, "jax", "INPUT", "coupler.res")
    assert trst.read_coupler_res(path) == jrst.read_coupler_res(path) == T0
    tpath = str(tmp_path / "coupler.res")
    trst.write_coupler_res(tpath, T0, T0 - datetime.timedelta(hours=3))
    jpath = str(tmp_path / "coupler_jax.res")
    jrst.write_coupler_res(jpath, T0, T0 - datetime.timedelta(hours=3))
    assert open(tpath).read() == open(jpath).read()


def test_restarts_from_state_takes_tensors():
    """The port's inverse takes tensors (on any device) as well as
    arrays, and gives the arrays' result."""
    state = _state(species=2)
    phis = np.zeros((6, N, N))
    want = trst.restarts_from_state(state, phis, PTOP)
    tstate = type(state)(*(torch.as_tensor(x) for x in state))
    got = trst.restarts_from_state(tstate, torch.as_tensor(phis), PTOP)
    for k, q in want.items():
        np.testing.assert_array_equal(got[k].values, q.values, k)


CASES = {
    # (restart species, w and delz in the files, model config)
    "hydrostatic_two": (2, False, dict()),
    "nonhydrostatic_six_padded": (
        2, True, dict(hydrostatic=False, physics_suite="gfs",
                      microphysics_scheme="gfdl",
                      prognostic_mp_tracers=True)),
    "nonhydrostatic_no_w_delz": (
        6, False, dict(hydrostatic=False, physics_suite="gfs",
                       microphysics_scheme="gfdl",
                       prognostic_mp_tracers=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_initialize_from_restart_matches_jax(tmp_path, case):
    species, nonhydro, kw = CASES[case]
    state = _state(species=species, nonhydrostatic=nonhydro)
    fields = _write(tmp_path, state)
    cfg = dict(npx=N + 1, npz=NZ, dtype="float64", n_split=4,
               restart_dir=str(tmp_path), **kw)
    jwrapper.initialize(jwrapper.ModelConfig(**cfg))
    twrapper.initialize(twrapper.ModelConfig(**cfg), device="cpu")
    jm, tm = jwrapper.get_model(), twrapper.get_model()
    assert tm.time == jm.time == T0
    nt = 6 if kw.get("prognostic_mp_tracers") else 2
    assert tm.state.q.shape[0] == nt
    for k, w in jm.state._asdict().items():
        g = getattr(tm.state, k)
        if w is None:
            assert g is None, k
            continue
        assert g.dtype == torch.float64 and g.device.type == "cpu", k
        if k == "delz" and not nonhydro:
            # w and delz absent from the files: both packages integrate
            # the hydrostatic thickness from the ingested state
            # (add_nonhydrostatic_fields), the same operations up to the
            # order of a sum: roundoff of float64
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=1e-13, err_msg=k)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), k)
    np.testing.assert_array_equal(tm.phis.numpy(), np.asarray(jm.phis))
    # the files hold f32-rounded fields (quirk: the ingest casts every
    # field to float32, as the JAX package does)
    np.testing.assert_array_equal(
        tm.state.delp.numpy(),
        fields["delp"].values.astype(np.float32).astype(np.float64))
    if species < nt:
        assert not bool(tm.state.q[species:].any())
    if not kw.get("hydrostatic", True):
        assert tm.state.w is not None
        if nonhydro:
            np.testing.assert_array_equal(
                tm.state.w.numpy(),
                state.w.astype(np.float32).astype(np.float64))


def test_initialize_from_restart_prefers_input_and_checks_resolution(
        tmp_path):
    state = _state(species=2, seed=4)
    _write(tmp_path, state, subdir="RESTART",
           time=T0 + datetime.timedelta(hours=6))
    cfg = dict(npx=N + 1, npz=NZ, dtype="float64", restart_dir=str(tmp_path))
    twrapper.initialize(twrapper.ModelConfig(**cfg), device="cpu")
    assert twrapper.get_model().time == T0 + datetime.timedelta(hours=6)
    _write(tmp_path, _state(species=2, seed=5), subdir="INPUT")
    twrapper.initialize(twrapper.ModelConfig(**cfg), device="cpu")
    mdl = twrapper.get_model()
    assert mdl.time == T0
    want = _state(species=2, seed=5).delp.astype(np.float32)
    np.testing.assert_array_equal(mdl.state.delp.numpy(), want)
    with pytest.raises(ValueError, match="resolution"):
        twrapper.initialize(twrapper.ModelConfig(**dict(cfg, npz=NZ + 1)),
                            device="cpu")
    with pytest.raises(FileNotFoundError):
        twrapper.initialize(
            twrapper.ModelConfig(**dict(cfg, restart_dir=str(tmp_path / "x"))),
            device="cpu")


def test_initialize_from_restart_defaults_to_the_card(tmp_path, monkeypatch):
    _write(tmp_path, _state(species=2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="initialize"):
        twrapper.initialize(twrapper.ModelConfig(
            npx=N + 1, npz=NZ, restart_dir=str(tmp_path)))
