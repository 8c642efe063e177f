"""The hydrostatic dycore (a state without w and delz): one dt of
fv3net_tpu_torch's make_dycore_stepper against the JAX package's (C12,
nz=8, k_split=1, n_split=6, hord=5, kord=9, one tracer, non-zero phis,
float64 on the CPU), remap_step without w and delz, and the kernels the
hydrostatic branch does not reach."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu.dycore import hydro as jhydro
from fv3net_tpu.grid import CubedSphereGrid as JGrid
from fv3net_tpu_torch.convert import state_from_numpy, state_to_numpy
from fv3net_tpu_torch.dycore import hydro as thydro
from fv3net_tpu_torch.grid import CubedSphereGrid as TGrid
from torch_parity import assert_close_scaled, benchmark_like_state

torch.set_num_threads(1)

n, NZ, DT, PTOP = 12, 8, 900.0, 300.0
# float64 through 6 substeps + remap.  Without w (the residual of
# cancelling pressure terms that sets the nonhydrostatic dt's 1e-9,
# tests/test_torch_dycore.py) every field agrees to ~1e-14 of its
# magnitude (measured: u 4.2e-14, v 4.0e-14, delp 1.7e-15, pt and q
# <= 7.5e-16), so 1e-12 of each field's magnitude
RTOL = 1e-12
FIELDS = ("delp", "pt", "u", "v", "q")


def _stepper(device="cpu"):
    return thydro.make_dycore_stepper(
        TGrid.make(n, halo=3), NZ, DT, k_split=1, n_split=6, hord=5,
        kord=9, ptop=PTOP, dtype=torch.float64, device=device,
    )


@pytest.fixture(scope="module")
def jax_run():
    delp, pt, u, v, q = benchmark_like_state(n, NZ, seed=3)
    phis = 2000.0 * np.abs(np.random.RandomState(4).randn(6, n, n))
    run, _, _ = jhydro.make_dycore_stepper(
        JGrid.make(n, halo=3), NZ, DT, k_split=1, n_split=6, hord=5,
        kord=9, ptop=PTOP, dtype=jnp.float64,
    )
    st = jhydro.DycoreState(*(jnp.asarray(a) for a in (delp, pt, u, v, q)))
    out = run(st, jnp.asarray(phis), 1)
    assert out.w is None and out.delz is None
    state = dict(zip(FIELDS, (delp, pt, u, v, q)))
    return state, phis, {k: np.asarray(getattr(out, k)) for k in FIELDS}


@pytest.fixture(scope="module")
def torch_run(jax_run):
    state, phis, _ = jax_run
    run, _, _ = _stepper()
    out = run(state_from_numpy(state, "cpu"), torch.as_tensor(phis), 1)
    return out


@pytest.mark.parametrize("field", FIELDS)
def test_hydrostatic_dt_matches_jax(jax_run, torch_run, field):
    got = state_to_numpy(torch_run)
    assert_close_scaled(got[field], jax_run[2][field], RTOL, name=field)


def test_hydrostatic_dt_keeps_no_w_or_delz(torch_run):
    assert torch_run.w is None and torch_run.delz is None


def test_hydrostatic_branch_reaches_no_nonhydrostatic_kernel(
        jax_run, monkeypatch):
    """On the CPU the hydrostatic dt never calls the five-transport forms
    (K6 and its plain form) or the vertical solve (K2), and its substep
    core never calls the column pressure chain (K4): each is replaced by
    a function that raises.  The C-grid half-stage does call K4's chain,
    once a substep, as the JAX package's half-stage does (its gate has no
    hydrostatic condition).  The dt still equals the JAX dt."""
    import sys

    def forbidden(name):
        def fn(*args, **kwargs):
            raise AssertionError(f"hydrostatic dt reached {name}")
        return fn

    for name in ("transports5", "fv_tp_2d_multi5", "sim1_solve"):
        monkeypatch.setattr(thydro, name, forbidden(name))
    callers = []
    column_pressures = thydro.column_pressures

    def watched(*args, **kwargs):
        caller = sys._getframe(1).f_code.co_name
        if caller != "_c_sw_half_3d":
            raise AssertionError(f"{caller} reached column_pressures")
        callers.append(caller)
        return column_pressures(*args, **kwargs)

    monkeypatch.setattr(thydro, "column_pressures", watched)
    state, phis, want = jax_run
    run, _, _ = _stepper()
    got = state_to_numpy(
        run(state_from_numpy(state, "cpu"), torch.as_tensor(phis), 1)
    )
    assert len(callers) == 6
    for k in FIELDS:
        assert_close_scaled(got[k], want[k], RTOL, name=k)


def test_hydrostatic_dt_counts_three_transports_a_substep(
        jax_run, monkeypatch):
    """K1's call sites on the hydrostatic path: three transports a
    substep (delp, pt, vorticity) and one a tracer; the filter twice a
    substep (delp, pt)."""
    calls = {"fv_tp_2d": 0, "scalar_filter": 0}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, wrapped)

    counted(thydro, "fv_tp_2d")
    counted(thydro, "scalar_filter")
    state, phis, _ = jax_run
    run, _, _ = _stepper()
    run(state_from_numpy(state, "cpu"), torch.as_tensor(phis), 1)
    assert calls == {"fv_tp_2d": 3 * 6 + 1, "scalar_filter": 2 * 6}


def test_remap_step_without_w_matches_jax():
    """remap_step of a state without w and delz (the hydrostatic remap)
    against the JAX package's, with distinct kords."""
    from fv3net_tpu.dycore.hydro import hybrid_coefficients
    from test_torch_dycore import _smooth_lagrangian_state

    arrays = _smooth_lagrangian_state(n, NZ, seed=9)[:5]
    ak, bk = hybrid_coefficients(NZ, PTOP)
    kords = dict(kord_tm=9, kord_mt=10, kord_tr=9, kord_wz=7)
    want = jhydro.remap_step(
        jhydro.DycoreState(*(jnp.asarray(a) for a in arrays)), ak, bk, PTOP,
        **kords,
    )
    got = thydro.remap_step(
        thydro.DycoreState(*(torch.as_tensor(a) for a in arrays)),
        torch.as_tensor(np.array(ak)), torch.as_tensor(np.array(bk)),
        PTOP, **kords,
    )
    assert got.w is None and got.delz is None
    for k in FIELDS:
        assert_close_scaled(getattr(got, k).numpy(),
                            np.asarray(getattr(want, k)), 1e-12, name=k)
