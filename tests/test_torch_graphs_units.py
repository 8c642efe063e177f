"""The units the JAX package jits one by one on the serving paths, as the
port's ``graphs.jit``, on the CPU.

- the key: a hashable frozen dataclass (``GFSPhysicsConfig``, the JAX
  package's static ``cfg``) is a constant of it, and other objects are
  refused;
- a second call with the same shapes captures nothing new: the wrapper's
  units on an emulated step (gscond and precpd, where the JAX wrapper
  jits a new lambda for precpd at each call, ROADMAP quirk (u)), and a
  unit keeps at most its bound of graphs (``graphs.MAX_CAPTURES``), the
  least recently used dropped with a warning.  A CUDA graph needs the
  card: here a stand-in capture runs the body, with the CPU as the
  captured device;
- no host read inside any unit (``NoHostRead(scalars=True)``): the
  wrapper's Held-Suarez forcing, saturation adjustment, GFS step (Zhao-
  Carr; GFDL with the prognostic hydrometeors), gscond and precpd, the
  gray radiation's core, the multiband driver's compute, the steppers'
  humidity limiter and one apply of each fit family;
- the multiband driver, with the day of year and the solar constant as
  tensors, against the JAX package's at four days of the year, in
  float64 (RTOL 1e-11 of each output's largest magnitude, as
  tests/test_torch_radiation.py).

The captured path itself needs the card: chip_smoke.py phase 10b.
"""

import dataclasses
import datetime
import logging
import types

import numpy as np
import pytest
import torch

from fv3net_tpu.physics import radiation as jrad
from fv3net_tpu_torch import graphs, parity
from fv3net_tpu_torch import wrapper as twrapper
from fv3net_tpu_torch.fit import _shared
from fv3net_tpu_torch.physics import gfs as tgfs
from fv3net_tpu_torch.physics import radiation as trad
from fv3net_tpu_torch.runtime import steppers as tsteppers
from torch_parity import NoHostRead, assert_close_scaled

torch.set_num_threads(1)

N, NZ, PTOP, DT = 6, 8, 300.0, 900.0
RTOL = 1e-11


class StandIn:
    """A capture that runs the body eagerly on each call: the bookkeeping
    of Graphed (keys, bound, order) without a CUDA graph."""

    made = 0

    def __init__(self, fn, args, leaves, spec, carry, donate):
        StandIn.made += 1
        self.fn, self.spec = fn, spec
        self.static_bytes = self.pool_bytes = 0

    def __call__(self, leaves, steps):
        return self.fn(*graphs._build(self.spec, iter(leaves)))


@pytest.fixture
def stand_in(monkeypatch):
    """jit units and Graphed capture CPU tensors, through StandIn."""
    monkeypatch.setattr(graphs, "_Capture", StandIn)
    monkeypatch.setattr(graphs, "CAPTURED_DEVICE", "cpu")
    StandIn.made = 0
    return StandIn


# --- the key ----------------------------------------------------------------


def test_frozen_config_is_a_constant_of_the_key():
    cfg = tgfs.GFSPhysicsConfig()
    spec = graphs._flatten((cfg,))[1]
    assert graphs._flatten((tgfs.GFSPhysicsConfig(),))[1] == spec
    for other in (dataclasses.replace(cfg, do_microphysics=False),
                  tgfs.GFSPhysicsConfig(microphysics_scheme="gfdl")):
        assert graphs._flatten((other,))[1] != spec
    leaves, spec = graphs._flatten((cfg, torch.ones(2)))
    assert len(leaves) == 1 and graphs._build(spec, iter(leaves))[0] is cfg
    with pytest.raises(TypeError, match="cannot capture"):
        graphs._flatten((twrapper.ModelConfig(),))  # not frozen

    @dataclasses.dataclass(frozen=True)
    class Unhashable:
        table: list = dataclasses.field(default_factory=list)

    with pytest.raises(TypeError, match="cannot capture"):
        graphs._flatten((Unhashable(),))


def test_one_capture_a_config(stand_in):
    t, qv, qc, u, v, delp, tsfc = _gfs_inputs()
    cfgs = [tgfs.GFSPhysicsConfig(),
            tgfs.GFSPhysicsConfig(do_microphysics=False)]
    step = tgfs.gfs_physics_step
    step.graphed.captures.clear()
    for cfg in cfgs + cfgs:
        out, _ = step(t, qv, qc, u, v, delp, tsfc, PTOP, DT, cfg=cfg)
        want, _ = step.eager(t, qv, qc, u, v, delp, tsfc, PTOP, DT, cfg=cfg)
        assert torch.equal(out["air_temperature"], want["air_temperature"])
    assert step.captures() == 2 and stand_in.made == 2


# --- captures once a key, and at most max_captures -------------------------


def test_second_emulated_step_captures_nothing(stand_in):
    """Quirk (u): the JAX wrapper traces precpd again at every call; the
    port captures each unit once a key.  The step through the stand-in
    equals the eager one."""
    def step():
        inputs = parity.moist_inputs(N, NZ)
        twrapper.initialize(twrapper.ModelConfig(
            npx=N + 1, npz=NZ, dtype="float64", physics_suite="gfs",
            do_radiation=False), device="cpu")
        twrapper.set_state(inputs)
        mdl = twrapper.get_model()
        mdl.emulation_hooks = (lambda sd: None,) * 3
        twrapper.apply_physics()
        return {k: x.clone() for k, x in mdl.state._asdict().items()
                if x is not None}

    with graphs.eager():
        want = step()
    units = (twrapper._gscond, twrapper._precpd, tgfs.gfs_physics_step)
    for unit in units:
        unit.graphed.captures.clear()
    first = step()
    made = stand_in.made
    assert [u.captures() for u in units] == [1, 1, 1] and made == 3
    again = step()
    assert stand_in.made == made
    assert [u.captures() for u in units] == [1, 1, 1]
    for k, w in want.items():
        assert torch.equal(first[k], w) and torch.equal(again[k], w), k


def test_captures_are_bounded_least_recently_used(stand_in, caplog):
    unit = graphs.jit(lambda x: 2.0 * x)
    unit.graphed.max_captures = 2
    with caplog.at_level(logging.WARNING, logger="fv3net_tpu_torch.graphs"):
        for n in (1, 2, 3):  # the third drops shape (1,)
            assert torch.equal(unit(torch.ones(n)), 2.0 * torch.ones(n))
        assert unit.captures() == 2 and stand_in.made == 3
        assert len(caplog.records) == 1
        assert "its bound" in caplog.records[0].getMessage()
        unit(torch.ones(2))  # a hit: (3,) is now the oldest
        assert stand_in.made == 3
        unit(torch.ones(1))  # drops (3,)
    shapes = [k[0][2][0][1] for k in unit.graphed.captures]
    assert shapes == [(2,), (1,)] and stand_in.made == 4
    assert len(caplog.records) == 2
    assert unit.memory() == 0


def test_jit_inlines_inside_a_capture_and_within_eager(stand_in):
    """A jit called inside another capture's body, or within eager(),
    runs its eager body: a jit inside a jit."""
    inner = graphs.jit(lambda x: x + 1.0)
    outer = graphs.Graphed(lambda x: inner(x) * 2.0)
    x = torch.ones(3)
    graphs._inside += 1
    try:
        assert torch.equal(inner(x), x + 1.0)
    finally:
        graphs._inside -= 1
    with graphs.eager():
        assert torch.equal(outer(x), 4.0 * x) and stand_in.made == 0
        assert torch.equal(inner(x), x + 1.0) and inner.captures() == 0
    assert torch.equal(outer(x), 4.0 * x) and stand_in.made == 2


# --- no host read inside a unit ---------------------------------------------


def _no_host_read(fn, *args, **kwargs):
    """fn's second call, under NoHostRead(scalars=True), equals its first
    (which builds the cached tables, as a capture's warm-up does)."""
    first = fn(*args, **kwargs)
    with NoHostRead(scalars=True):
        again = fn(*args, **kwargs)
    a, b = graphs._flatten(first)[0], graphs._flatten(again)[0]
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _gfs_inputs(n=N, nz=NZ):
    """A moist C<n> state's GFS-step inputs (float64, the CPU)."""
    inputs = parity.moist_inputs(n, nz)
    twrapper.set_state(inputs)
    mdl = twrapper.get_model()
    st = mdl.state
    return (mdl._temperature(), st.q[0], st.q[1], st.u, st.v, st.delp,
            mdl._tsfc_tensor())


def test_no_host_read_in_the_wrappers_units():
    t, qv, qc, u, v, delp, tsfc = _gfs_inputs()
    mdl = twrapper.get_model()
    pe, _ = mdl._pressure_layers(delp)
    p = 0.5 * (pe[:, 1:] + pe[:, :-1])
    _no_host_read(twrapper._held_suarez_tendencies.eager, t, u, v, pe,
                  mdl._lat_t, DT)
    _no_host_read(twrapper._saturation_adjustment.eager, t, qv, qc, p,
                  delp, DT)
    cfg = tgfs.GFSPhysicsConfig()
    _no_host_read(tgfs.gfs_physics_step.eager, t, qv, qc, u, v, delp, tsfc,
                  PTOP, DT, cfg=cfg)
    _no_host_read(twrapper._gscond.eager, t, qv, qc, p, DT)
    _no_host_read(twrapper._precpd.eager, t, qv, qc, p, delp, DT, cfg)
    gfdl = tgfs.GFSPhysicsConfig(microphysics_scheme="gfdl",
                                 convection_scheme="mass_flux")
    hydrometeors = tuple(0.1 * qc * (i + 1) for i in range(4))
    h_std = 100.0 * torch.ones_like(tsfc)
    _no_host_read(tgfs.gfs_physics_step.eager, t, qv, qc, u, v, delp, tsfc,
                  PTOP, DT, cfg=gfdl, h_std=h_std, mp_tracers=hydrometeors)


def test_no_host_read_in_the_radiation_drivers():
    t, qv, qc, _, _, delp, tsfc = _gfs_inputs()
    pe, _ = twrapper.get_model()._pressure_layers(delp)
    p = 0.5 * (pe[:, 1:] + pe[:, :-1])
    rng = np.random.RandomState(4)
    cosz = torch.as_tensor(np.maximum(rng.uniform(-0.5, 1.0, tsfc.shape), 0))
    gray = trad.RadiationDriver()
    _no_host_read(gray._jit_core.eager, cosz, p, delp, t, qv, tsfc,
                  torch.tensor(1361.0, dtype=torch.float64))
    multi = trad.MultibandRadiationDriver()
    lat = torch.as_tensor(rng.uniform(-80.0, 80.0, tsfc.shape))
    f64 = dict(dtype=torch.float64)
    _no_host_read(multi._jit.eager, cosz, p, delp, t, qv, qc, 0.2 * qc,
                  tsfc, torch.tensor(1361.0, **f64), lat,
                  torch.tensor(213.0, **f64), (lat > 0).double(),
                  torch.zeros_like(tsfc))


def test_no_host_read_in_the_humidity_limiter():
    rng = np.random.RandomState(5)
    q = torch.as_tensor(rng.uniform(0.0, 1e-3, (6, NZ, N, N)))
    d1, d2 = (torch.as_tensor(rng.standard_normal(q.shape) * s)
              for s in (1e-4, 1e-6))
    _no_host_read(tsteppers._non_negative_sphum.eager, q, d1, d2, dt=DT)


# one apply a family, at a few channels and levels


def _scaler(n):
    s = _shared.StandardScaler()
    s.mean, s.std = np.linspace(0.0, 1.0, n), np.linspace(1.0, 2.0, n)
    return s


def _dense():
    from fv3net_tpu_torch.fit import dense
    from fv3net_tpu_torch.util.quantity import Quantity

    names_in, names_out = ["air_temperature", "specific_humidity"], ["dQ1"]
    rng = np.random.RandomState(0)
    dims = ("tile", "z", "y", "x")
    X = {k: Quantity(rng.standard_normal((6, NZ, N, N)), dims)
         for k in names_in + names_out}
    packers = [_shared.ArrayPacker(v) for v in (names_in, names_out)]
    for pk in packers:
        pk.to_array(X)
    model = dense.DenseModel(names_in, names_out, *packers,
                             _scaler(2 * NZ), _scaler(NZ),
                             dense._MLP(2 * NZ, [16, 16], NZ))
    arrs = {k: torch.as_tensor(X[k].data) for k in names_in}
    return [(model._apply, torch.randn(36, 2 * NZ)),
            (model._dev_fn, model.params_on("cpu"), arrs)]


def _cube_families():
    from fv3net_tpu_torch.fit import convolutional, generative, graph

    c = 3
    x = torch.randn(6, 8, 8, c)
    wide = {"a": c}
    conv = convolutional.ConvolutionalModel(
        ["a"], ["a"], wide, wide, None, None,
        convolutional._CNN(c, 4, 2, 3, c), 2)
    gnn = graph.GraphModel(["a"], ["a"], wide, wide, None, None, None,
                           graph._GraphMPG(c, 8, 2, c))
    ae = generative.AutoencoderModel(["a"], wide, None,
                                     generative._AE(c, 4, 2, 2, c))
    gan = generative.CycleGANModel(
        ["a"], ["b"], wide, None, None,
        *(generative._Generator(c, 4, 1, c) for _ in range(2)))
    return [(conv._apply, x), (gnn._apply, x), (ae._apply, x),
            (ae._encode, x), (gan._fwd, x), (gan._bwd, x)]


def _column_families():
    from fv3net_tpu_torch.fit import precipitative, recurrent, reservoir

    prec = precipitative.PrecipitativeModel(
        ["a"], None, None, _scaler(NZ), _scaler(NZ),
        precipitative._Trunk(2 * NZ, [8], NZ), NZ)
    fmr = recurrent.FMRModel(["f"], ["s"], None, None, None, None, None,
                             recurrent._FMRCore(8, 3, 2))
    hp = reservoir.ReservoirHyperparameters(state_size=16)
    res = reservoir.ReservoirComputingModel(
        ["a"], ["a"], hp, reservoir.Reservoir(hp, 5, device="cpu"),
        torch.zeros(32, 4), types.SimpleNamespace(n_subdomains=2), None,
        None)
    return [(prec._jit_fwd, torch.randn(20, 2 * NZ), torch.rand(20, NZ)),
            (fmr._jit_rollout, torch.randn(10, 3), torch.randn(4, 10, 2)),
            (res._step, torch.randn(12, 5), res._x)]


def _transformed():
    from fv3net_tpu_torch.fit import transformed

    spec = [{"to": "tdiff", "before": "air_temperature_input",
             "after": "air_temperature_after_gscond"}]
    hp = transformed.TransformedParameters.from_dict(dict(
        tensor_transform=spec,
        model={"input_variables": ["air_temperature_input",
                                   "specific_humidity_input"],
               "direct_out_variables": ["tdiff"]},
        loss={"loss_variables": ["tdiff"]}, epochs=1, batch_size=16))
    rng = np.random.RandomState(1)
    t = 250.0 + 30.0 * rng.rand(32, NZ)
    batch = {"air_temperature_input": t,
             "air_temperature_after_gscond": t + rng.randn(32, NZ),
             "specific_humidity_input": 1e-3 * rng.rand(32, NZ)}
    model = transformed.train_transformed(
        hp, [{k: v.astype(np.float32) for k, v in batch.items()}],
        device="cpu")
    n_in = model.module.trunk[0].in_features
    return [(model._apply, torch.randn(32, n_in))]


@pytest.mark.parametrize("family", ["dense", "cube", "column",
                                    "transformed"])
def test_no_host_read_in_the_predictors_apply(family):
    units = {"dense": _dense, "cube": _cube_families,
             "column": _column_families, "transformed": _transformed}[family]
    for unit, *args in units():
        assert isinstance(unit, graphs.jit)
        _no_host_read(unit.eager, *args)
        # on CPU tensors the unit is its eager body
        for a, b in zip(graphs._flatten(unit(*args))[0],
                        graphs._flatten(unit.eager(*args))[0]):
            assert torch.equal(a, b)


# --- the multiband driver with a tensor day of year -------------------------


def _cube(n, nz, seed=3):
    rng = np.random.RandomState(seed)
    pe = np.linspace(100.0, 101325.0, nz + 1)
    pe = pe[None, :, None, None] * (1.0 + 0.01 * rng.rand(6, 1, n, n))
    p_lay = 0.5 * (pe[:, 1:] + pe[:, :-1])
    return dict(
        p_lay=p_lay, delp=pe[:, 1:] - pe[:, :-1],
        temp=288.0 - 60.0 * (1.0 - p_lay / 101325.0)
        + rng.randn(6, nz, n, n),
        sphum=0.012 * (p_lay / 101325.0) ** 3
        * (0.4 + 0.9 * rng.rand(6, nz, n, n)),
        tsfc=285.0 + 10.0 * rng.rand(6, n, n),
        lat=rng.uniform(-85.0, 85.0, (6, n, n)),
        lon=rng.uniform(0.0, 360.0, (6, n, n)),
    )


@pytest.mark.parametrize("day", ["2016-01-15", "2016-04-15", "2016-08-01",
                                 "2016-10-15"])
def test_multiband_driver_tensor_day_matches_jax(day):
    """The day of year reaches the ozone and aerosol climatologies as a
    0-d tensor (the JAX package's traced doy); float64 on the CPU."""
    time = datetime.datetime.fromisoformat(day) + datetime.timedelta(
        hours=12)
    c = _cube(4, 8)
    jd, td = jrad.MultibandRadiationDriver(), trad.MultibandRadiationDriver()
    jd.radupdate(time)
    td.radupdate(time)
    fields = ("p_lay", "delp", "temp", "sphum", "tsfc")
    want = jd.gfs_radiation_driver(time, c["lon"], c["lat"],
                                   *(c[k] for k in fields))
    got = td.gfs_radiation_driver(
        time, c["lon"], c["lat"],
        *(torch.as_tensor(c[k]) for k in fields))
    assert set(got) == set(want)
    for k in want:
        assert_close_scaled(got[k].numpy(), want[k], RTOL, f"{day} {k}")
