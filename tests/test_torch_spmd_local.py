"""The multi-rank dycore of fv3net_tpu_torch.parallel.spmd_dycore on a
local mesh (parallel.mesh.LocalMesh): every shard of one process, each
run by a thread of its own, exchanging tensors in memory
(halo_spmd.LocalComm).  Float64 on the CPU, C8 x 4 levels, one
nonhydrostatic dt (k_split=1, n_split=2), as
tests/test_torch_spmd_dycore.py runs the process-rank meshes:

- the face mesh and the (F=2, Y=2, X=2) and (2, 1, 1) tiled meshes equal
  the JAX package's single-device dt to 1e-12 (the JAX package's own
  gate for its meshes, tests/test_spmd_dycore.py,
  tests/test_tiled_dycore.py);
- the face mesh and (2, 1, 1) equal the port's single-process dt bit
  for bit;
- built with remat=True, the meshes step as they do without it (bit for
  bit), as the process-rank cases do;
- ``run`` through a stand-in capture (``graphs.CAPTURED_DEVICE`` the
  CPU: ``graphs.Graphed`` takes the CPU tensors, a capture that replays
  the body eagerly) equals the eager loop bit for bit, over two dts;
- no host read in one dt of every shard (``NoHostRead(scalars=True)``
  entered in each shard's thread, after a warm-up dt has cached the
  exchange tables);
- an exception in one shard makes ``run`` raise it at once, and a shard
  that holds its turn makes the others raise within their timeout: no
  hang;
- two threads in ``spmd_mode`` over different axes each see their own;
- ``global_mean`` over a local mesh (on the device, in float64 sums)
  against the whole cube's mean;
- the kernels' launch counters lose no update when many threads count at
  once (``ops._build.launched``), and each thread's tally holds its own.

The CUDA-graph capture itself needs the card: tests/test_torch_cuda.py
and chip_smoke.py's local-mesh phases."""

import sys
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu.dycore.hydro import DycoreState as JState
from fv3net_tpu.dycore.hydro import add_nonhydrostatic_fields
from fv3net_tpu.dycore.hydro import make_dycore_stepper as j_stepper
from fv3net_tpu.grid import CubedSphereGrid as JGrid
from fv3net_tpu_torch import graphs
from fv3net_tpu_torch.dycore.hydro import DycoreState as TState
from fv3net_tpu_torch.dycore.hydro import make_dycore_stepper as t_stepper
from fv3net_tpu_torch.grid import halo as halo_mod
from fv3net_tpu_torch.grid.geometry import CubedSphereGrid as TGrid
from fv3net_tpu_torch.ops import _build
from fv3net_tpu_torch.parallel import spmd_dycore
from fv3net_tpu_torch.parallel.mesh import global_mean, make_local_mesh
from fv3net_tpu_torch.parallel.tiling import TileLayout
from torch_parity import NoHostRead, StandInCapture, benchmark_like_state

torch.set_num_threads(1)

N, NZ, DT, NSPLIT, H = 8, 4, 900.0, 2, 3
LAYOUTS = {"face": (6, 1, 1), "tiled_2_2_2": (2, 2, 2),
           "tiled_2_1_1": (2, 1, 1)}
TOL = 1e-12


def _stepper(layout, remat=False, timeout_s=60.0):
    mesh = make_local_mesh(layout, timeout_s=timeout_s)
    g = TGrid.make(N, halo=H)
    kw = dict(dt_atmos=DT, k_split=1, n_split=NSPLIT, dtype=torch.float64,
              remat=remat, device="cpu")
    if layout == (6, 1, 1):
        return mesh, spmd_dycore.make_spmd_dycore_stepper(g, NZ, mesh, **kw)
    lay = TileLayout(N, H, *layout)
    return mesh, spmd_dycore.make_tiled_spmd_dycore_stepper(
        g, NZ, mesh, lay, **kw)


@pytest.fixture(scope="module")
def inputs():
    delp, pt, u, v, q = benchmark_like_state(N, NZ)
    st = add_nonhydrostatic_fields(
        JState(*map(jnp.asarray, (delp, pt, u, v, q))), 300.0
    )
    arrays = {k: np.asarray(x) for k, x in zip(JState._fields, st)}
    return arrays, np.zeros((6, N, N))


def _state(arrays):
    return TState(*[torch.as_tensor(np.array(arrays[k]))
                    for k in TState._fields])


@pytest.fixture(scope="module")
def singles(inputs):
    """The JAX package's single-device dt and the port's."""
    arrays, phis = inputs
    run_j, _, _ = j_stepper(JGrid.make(N, halo=H), NZ, dt_atmos=DT,
                            k_split=1, n_split=NSPLIT, dtype=jnp.float64)
    want_j = run_j(JState(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                   jnp.asarray(phis), 1)
    run_t, _, _ = t_stepper(TGrid.make(N, halo=H), NZ, dt_atmos=DT,
                            k_split=1, n_split=NSPLIT, dtype=torch.float64,
                            device="cpu")
    want_t = run_t(_state(arrays), torch.as_tensor(phis), 1)
    return want_j, want_t


@pytest.fixture(scope="module")
def local_dts(inputs):
    """One dt of every local mesh, with and without remat: the gathered
    states."""
    arrays, phis = inputs
    out = {}
    for name, layout in LAYOUTS.items():
        for remat in (False, True):
            if remat and name == "tiled_2_2_2":
                continue
            _, (run, shard, gather) = _stepper(layout, remat)
            sharded, ph = shard(_state(arrays), torch.as_tensor(phis))
            out[name + "_remat" * remat] = gather(run(sharded, ph, 1))
    return out


@pytest.mark.parametrize("mode", list(LAYOUTS))
def test_local_mesh_dt_matches_jax_single_device(local_dts, singles, mode):
    want_j, _ = singles
    for k in TState._fields:
        np.testing.assert_allclose(
            getattr(local_dts[mode], k).numpy(),
            np.asarray(getattr(want_j, k)), rtol=TOL, atol=TOL,
            err_msg=f"{mode} {k}")


@pytest.mark.parametrize("mode", ["face", "tiled_2_1_1"])
def test_local_whole_face_meshes_match_single_process_bitwise(
        local_dts, singles, mode):
    _, want_t = singles
    for k in TState._fields:
        got, w = getattr(local_dts[mode], k), getattr(want_t, k)
        assert torch.equal(got, w), (
            f"{mode} {k}: max |diff| {(got - w).abs().max():.3e}")


@pytest.mark.parametrize("mode", ["face", "tiled_2_1_1"])
def test_local_remat_steppers_match_plain(local_dts, singles, mode):
    want_j, _ = singles
    for k in TState._fields:
        r = getattr(local_dts[f"{mode}_remat"], k)
        assert torch.equal(r, getattr(local_dts[mode], k)), f"{mode} {k}"
        np.testing.assert_allclose(
            r.numpy(), np.asarray(getattr(want_j, k)), rtol=TOL, atol=TOL,
            err_msg=f"{mode} remat {k}")


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(graphs, "_Capture", StandInCapture)
    monkeypatch.setattr(graphs, "CAPTURED_DEVICE", "cpu")
    StandInCapture.made = 0
    return StandInCapture


@pytest.mark.parametrize("mode", ["face", "tiled_2_1_1"])
def test_local_run_through_stand_in_capture_equals_eager(inputs, stand_in,
                                                         mode):
    arrays, phis = inputs
    _, (run, shard, gather) = _stepper(LAYOUTS[mode])
    sharded, ph = shard(_state(arrays), torch.as_tensor(phis))
    want = run.one_dt(run.one_dt(sharded, ph), ph)
    got = run(sharded, ph, 2)
    assert stand_in.made == 1 and len(got) == len(sharded)
    for a, b in zip(gather(got), gather(want)):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)
    # the caller's shards are untouched
    again = shard(_state(arrays), torch.as_tensor(phis))[0]
    for s, t in zip(sharded, again):
        assert all(a is None or torch.equal(a, b) for a, b in zip(s, t))


@pytest.mark.parametrize("mode", ["face", "tiled_2_1_1"])
def test_no_host_read_in_local_dt(inputs, mode):
    arrays, phis = inputs
    mesh, (run, shard, _) = _stepper(LAYOUTS[mode])
    sharded, ph = shard(_state(arrays), torch.as_tensor(phis))
    run(sharded, ph, 1)  # the warm-up: exchange tables cached
    mesh.thread_context = lambda: NoHostRead(scalars=True)
    run(sharded, ph, 1)
    with pytest.raises(RuntimeError, match="host read"):
        mesh.map(lambda d: float(sharded[d].delp.sum()))


def test_failing_shard_raises_without_hang(inputs):
    arrays, phis = inputs
    mesh, (run, shard, _) = _stepper(LAYOUTS["face"], timeout_s=30.0)
    sharded, ph = shard(_state(arrays), torch.as_tensor(phis))
    ph = list(ph)
    ph[3] = "not a tensor"  # shard 3 fails at its first use of phis
    t0 = time.perf_counter()
    with pytest.raises(AttributeError, match="shape"):
        run(sharded, ph, 1)
    assert time.perf_counter() - t0 < 30.0

    # a shard that holds its turn past the others' timeout
    mesh = make_local_mesh((6, 1, 1), timeout_s=0.5)

    def body(d):
        if d == 0:
            time.sleep(2.0)
            return None
        return mesh.comm(d).exchange({}, {}, torch.zeros(1))

    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        mesh.map(body)
    assert time.perf_counter() - t0 < 10.0
    # the mesh runs again after a broken run
    assert mesh.map(lambda d: mesh.comm(d).exchange(
        {(d + 1) % 6: torch.full((2,), float(d))}, {(d - 1) % 6: 2},
        torch.zeros(1))[(d - 1) % 6][0].item()) == [5.0, 0.0, 1.0, 2.0,
                                                    3.0, 4.0]


def test_spmd_mode_is_thread_local():
    mesh = make_local_mesh((6, 1, 1))
    barrier = threading.Barrier(2, timeout=10.0)
    seen = {}

    def body(name, axis):
        with halo_mod.spmd_mode(axis):
            barrier.wait()  # both threads inside their spmd_mode
            seen[name] = (halo_mod.spmd_axis(), halo_mod.spmd_active())
            barrier.wait()

    threads = [threading.Thread(target=body, args=(d, mesh.comm(d)))
               for d in (1, 4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20.0)
        assert not t.is_alive()
    assert seen == {1: (mesh.comm(1), True), 4: (mesh.comm(4), True)}
    assert halo_mod.spmd_axis() is None and not halo_mod.spmd_active()


def test_global_mean_over_local_mesh():
    rng = np.random.RandomState(3)
    field = torch.as_tensor(rng.randn(6, N, N))
    area = torch.as_tensor(1.0 + rng.rand(6, N, N))
    mesh = make_local_mesh((6, 1, 1))
    got = global_mean([field[f:f + 1] for f in range(6)],
                      [area[f:f + 1] for f in range(6)], mesh)
    want = torch.sum(field * area) / torch.sum(area)
    assert got.dtype == torch.float64 and got.ndim == 0
    torch.testing.assert_close(got, want, rtol=1e-14, atol=0.0)


def test_launch_counters_lose_no_update():
    wrapper = types.SimpleNamespace(launches=0, counter_name="fv_tp_2d")
    threads, calls, tallies = 16, 2000, []

    def count():
        with _build.tally() as mine:
            for _ in range(calls):
                _build.launched(wrapper)
        tallies.append(mine["fv_tp_2d"])

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=count) for _ in range(threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(60.0)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(before)
    assert wrapper.launches == threads * calls
    assert tallies == [calls] * threads
