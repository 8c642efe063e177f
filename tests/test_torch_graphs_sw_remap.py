"""Two more of the JAX package's jits as the port's captured graphs, on the
CPU through a stand-in capture (``graphs.CAPTURED_DEVICE`` the CPU, each
replay the body run eagerly on the capture's arguments):

- the shallow-water stepper's ``run`` (``make_sw_stepper``: the JAX
  package jits a ``lax.scan`` of the step, fv3net_tpu/dycore/sw.py:1297):
  a ``graphs.Graphed`` of one step, carried; three steps through the
  stand-in equal three eager steps bit for bit, and the JAX package's
  stepper within its parity test's tolerance (C12, float64, Williamson 2
  with seeded noise, tests/test_torch_sw_model.py);
- ``ops.remap.ppm_remap`` as a ``graphs.jit`` unit (the JAX package jits
  it with iv, kord and exact_boundaries static,
  fv3net_tpu/ops/remap.py:662): through the stand-in it equals its eager
  body bit for bit and the JAX package's ppm_remap to 1e-12 (float64),
  with one capture a key (iv, kord and exact_boundaries constants of
  it); the pressure-level coarsening and the fine-resolution budget
  reach it;
- no host read in one SW step or one remap (``NoHostRead(scalars=True)``).

The CUDA graphs themselves need the card: tests/test_torch_cuda.py and
chip_smoke.py phases 21-22."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu.dycore import sw as jsw
from fv3net_tpu.grid import CubedSphereGrid as JGrid
from fv3net_tpu.ops import remap as jremap
from fv3net_tpu_torch import graphs
from fv3net_tpu_torch.convert import sw_state_from_numpy
from fv3net_tpu_torch.dycore import sw as tsw
from fv3net_tpu_torch.grid import CubedSphereGrid as TGrid
from fv3net_tpu_torch.ops import remap as tremap
from fv3net_tpu_torch.utils import coarsen_restarts, fine_res_budget
from test_remap import _edges, random_columns
from test_sw import w2_fields
from torch_parity import NoHostRead, StandInCapture

torch.set_num_threads(1)

H, N, SW_STEPS = 3, 12, 3


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(graphs, "_Capture", StandInCapture)
    monkeypatch.setattr(graphs, "CAPTURED_DEVICE", "cpu")
    StandInCapture.made = 0
    return StandInCapture


@pytest.fixture(scope="module")
def sw_state():
    depth, u, v = w2_fields(JGrid.make(N, halo=H))
    rng = np.random.RandomState(0)
    return (depth + rng.randn(*depth.shape), u + rng.randn(*u.shape),
            v + rng.randn(*v.shape))


def _sw_run():
    return tsw.make_sw_stepper(TGrid.make(N, halo=H), 300.0,
                               dtype=torch.float64, device="cpu")[0]


def test_sw_run_through_stand_in_capture(sw_state, stand_in):
    run = _sw_run()
    st = sw_state_from_numpy(sw_state, "cpu")
    want = st
    for _ in range(SW_STEPS):
        want = run.one_step(want)
    got = run(st, SW_STEPS)
    assert stand_in.made == 1
    for k, a, b in zip(tsw.ShallowWaterState._fields, got, want):
        assert torch.equal(a, b), k
    run(st, 1)  # the same key: no second capture
    assert stand_in.made == 1
    run_j, _ = jsw.make_sw_stepper(JGrid.make(N, halo=H), 300.0,
                                   dtype=jnp.float64)
    jwant = run_j(jsw.ShallowWaterState(*(jnp.asarray(a) for a in sw_state)),
                  SW_STEPS)
    # tests/test_torch_sw_model.py's stepper tolerance
    for k, a, w in zip(tsw.ShallowWaterState._fields, got, jwant):
        w = np.asarray(w)
        np.testing.assert_allclose(
            a.numpy(), w, rtol=1e-10, atol=1e-11 * max(np.abs(w).max(), 1.0),
            err_msg=k)


def test_no_host_read_in_sw_step(sw_state):
    run = _sw_run()
    st = sw_state_from_numpy(sw_state, "cpu")
    run.one_step(st)  # the warm-up: tables cached on first call
    with NoHostRead(scalars=True):
        run.one_step(st)


def _remap_args():
    """Smooth columns, target edges past both ends of the source column
    (tests/test_torch_remap.py::test_ppm_remap_matches_jax)."""
    ncol, km, kn = 8, 20, 17
    q, _ = random_columns(ncol, km, seed=21, smooth=True)
    pe1 = _edges(ncol, km, 100.0, 1000.0, seed=22)
    pe2 = _edges(ncol, kn, 80.0, 1050.0, seed=23)
    return q.T.copy(), pe1.T.copy(), pe2.T.copy()


def test_ppm_remap_unit_through_stand_in_capture(stand_in):
    args = _remap_args()
    t = [torch.as_tensor(a) for a in args]
    keys = [(1, 9, False), (1, 9, True), (1, 10, False), (0, 9, True)]
    for iv, kord, exact in keys + keys:
        got = tremap.ppm_remap(*t, iv=iv, kord=kord, exact_boundaries=exact)
        eager = tremap.ppm_remap.eager(*t, iv=iv, kord=kord,
                                       exact_boundaries=exact)
        assert torch.equal(got, eager)
        want = jremap.ppm_remap(*(jnp.asarray(a) for a in args), iv=iv,
                                kord=kord, exact_boundaries=exact)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)
    # one capture a key: iv, kord and exact_boundaries join it
    assert stand_in.made == len(keys)
    assert tremap.ppm_remap.captures() == len(keys)
    tremap.ppm_remap.graphed.captures.clear()


def test_coarsening_and_budget_reach_the_remap_unit(stand_in):
    """The pressure-level coarsening's remap and the budget's
    pressure-level average call the unit (one capture each: mappm's rules
    and the exact boundaries), and equal their eager runs bit for bit."""
    rng = np.random.RandomState(4)
    nz, n, factor = 6, 8, 2
    delp = torch.as_tensor(1000.0 + 50.0 * rng.rand(6, nz, n, n))
    temp = torch.as_tensor(250.0 + rng.randn(6, nz, n, n))
    area = torch.as_tensor(1.0 + rng.rand(6, n, n))
    state = {"pressure_thickness_of_atmospheric_layer": delp,
             "air_temperature": temp}
    tremap.ppm_remap.graphed.captures.clear()
    got = coarsen_restarts.coarsen_restarts_on_pressure(state, area, factor)
    delp_c = got["pressure_thickness_of_atmospheric_layer"]
    avg = fine_res_budget.pressure_level_average(temp, delp, delp_c, area,
                                                 factor)
    assert stand_in.made == 2 and tremap.ppm_remap.captures() == 2
    with graphs.eager():
        want = coarsen_restarts.coarsen_restarts_on_pressure(state, area,
                                                             factor)
        want_avg = fine_res_budget.pressure_level_average(
            temp, delp, delp_c, area, factor)
    assert stand_in.made == 2
    for k in want:
        assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(want[k]))
    assert torch.equal(avg, want_avg)
    tremap.ppm_remap.graphed.captures.clear()


def test_no_host_read_in_ppm_remap():
    t = [torch.as_tensor(a) for a in _remap_args()]
    for exact in (False, True):
        with NoHostRead(scalars=True):
            tremap.ppm_remap(*t, iv=1, kord=9, exact_boundaries=exact)
