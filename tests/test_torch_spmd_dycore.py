"""The multi-rank dycore of fv3net_tpu_torch.parallel.spmd_dycore over gloo
ranks on the CPU (tests/torch_spmd_worker.py), float64, C8 x 4 levels,
one nonhydrostatic dt (k_split=1, n_split=2):

- the 6-rank face mesh and the (F=2, Y=2, X=2) tiled mesh (8 ranks, three
  faces' tiles each) equal the JAX package's single-device dt to 1e-12
  (the JAX package's own gate for its meshes, tests/test_spmd_dycore.py,
  tests/test_tiled_dycore.py);
- the face mesh, and 2 ranks of 3 whole faces each (the JAX package's
  tests/test_multihost.py layout, here TileLayout(F=2, Y=1, X=1)), equal
  the port's single-process dt bit for bit: the same arithmetic on each
  face, exchanges that copy, and transposes that sum in the
  single-process order;
- both steppers built with remat=True (the JAX package's flag: the
  substeps checkpointed) step as they do without it: to 1e-12 of the
  JAX package's dt built with remat=True, and bit for bit with the
  port's dt without it.

The ranks run while the parent compiles the JAX step."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu.dycore.hydro import DycoreState as JState
from fv3net_tpu.dycore.hydro import add_nonhydrostatic_fields
from fv3net_tpu.dycore.hydro import make_dycore_stepper as j_stepper
from fv3net_tpu.grid import CubedSphereGrid as JGrid
from fv3net_tpu_torch.dycore.hydro import DycoreState as TState
from fv3net_tpu_torch.dycore.hydro import make_dycore_stepper as t_stepper
from fv3net_tpu_torch.grid.geometry import CubedSphereGrid as TGrid
from fv3net_tpu_torch.parallel import multihost
from torch_parity import benchmark_like_state

N, NZ, DT, NSPLIT = 8, 4, 900.0, 2
WORKER = os.path.join(os.path.dirname(__file__), "torch_spmd_worker.py")
MESHES = {"face": 6, "tiled_2_2_2": 8, "tiled_2_1_1": 2,
          "face_remat": 6, "tiled_2_1_1_remat": 2}
FIELDS = ("delp", "pt", "u", "v", "q", "w", "delz")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("spmd_dycore")
    delp, pt, u, v, q = benchmark_like_state(N, NZ)
    st = add_nonhydrostatic_fields(
        JState(*map(jnp.asarray, (delp, pt, u, v, q))), 300.0
    )
    arrays = {k: np.asarray(x) for k, x in zip(JState._fields, st)}
    phis = np.zeros((6, N, N))
    np.savez(d / "inp.npz", phis=phis, n=N, nz=NZ, dt=DT, n_split=NSPLIT,
             **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    groups = {}
    for mode, nprocs in MESHES.items():
        sub = d / mode
        sub.mkdir()
        groups[mode] = multihost.spawn(
            [WORKER, mode, str(d / "inp.npz"), str(sub)], nprocs,
            str(sub / "store"), timeout_s=600, env=env,
        )
    try:
        # meanwhile: the JAX package's and the port's single-process dts
        run_j, _, _ = j_stepper(JGrid.make(N, halo=3), NZ, dt_atmos=DT,
                                k_split=1, n_split=NSPLIT,
                                dtype=jnp.float64)
        want_j = run_j(st, jnp.asarray(phis), 1)
        run_jr, _, _ = j_stepper(JGrid.make(N, halo=3), NZ, dt_atmos=DT,
                                 k_split=1, n_split=NSPLIT,
                                 dtype=jnp.float64, remat=True)
        want_jr = run_jr(st, jnp.asarray(phis), 1)
        run_t, _, _ = t_stepper(TGrid.make(N, halo=3), NZ, dt_atmos=DT,
                                k_split=1, n_split=NSPLIT,
                                dtype=torch.float64, device="cpu")
        state_t = TState(*[torch.as_tensor(np.array(arrays[k]))
                           for k in FIELDS])
        want_t = run_t(state_t, torch.as_tensor(phis), 1)
        got = {}
        for mode, group in groups.items():
            group.wait()
            got[mode] = torch.load(d / mode / f"{mode}_rank0.pt")
    finally:
        for group in groups.values():
            group.kill()
    return got, want_j, want_t, want_jr


@pytest.mark.parametrize("mode", ["face", "tiled_2_2_2"])
def test_multi_rank_dt_matches_jax_single_device(runs, mode):
    got, want_j, _, _ = runs
    for k in FIELDS:
        np.testing.assert_allclose(
            got[mode][k].numpy(), np.asarray(getattr(want_j, k)),
            rtol=1e-12, atol=1e-12, err_msg=f"{mode} {k}",
        )


@pytest.mark.parametrize("mode", ["face", "tiled_2_1_1"])
def test_whole_face_ranks_match_single_process_bitwise(runs, mode):
    got, _, want_t, _ = runs
    for k in FIELDS:
        w = getattr(want_t, k)
        assert torch.equal(got[mode][k], w), (
            f"{mode} {k}: max |diff| {(got[mode][k] - w).abs().max():.3e}"
        )


@pytest.mark.parametrize("mode", ["face", "tiled_2_1_1"])
def test_remat_steppers_match_jax_remat_and_plain(runs, mode):
    got, want_j, _, want_jr = runs
    for k in FIELDS:
        r = got[f"{mode}_remat"][k]
        np.testing.assert_allclose(
            r.numpy(), np.asarray(getattr(want_jr, k)), rtol=1e-12,
            atol=1e-12, err_msg=f"{mode} remat {k}",
        )
        assert torch.equal(r, got[mode][k]), f"{mode} remat {k}"
