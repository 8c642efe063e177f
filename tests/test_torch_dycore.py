"""The slice as a whole: one dt of fv3net_tpu_torch's make_dycore_stepper
against the JAX package's stepper (C12, nz=8, k_split=1, n_split=6,
hord=5, kord=9, one tracer, non-zero phis, float64 on the CPU), and the
port alone against the stored C12 x 63 trajectory."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu.dycore import hydro as jhydro
from fv3net_tpu.grid import CubedSphereGrid as JGrid
from fv3net_tpu_torch.convert import (
    metrics_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from fv3net_tpu_torch.dycore import hydro as thydro
from fv3net_tpu_torch.grid import CubedSphereGrid as TGrid
from torch_parity import (
    assert_close_scaled,
    benchmark_like_state,
    jax_metrics_arrays,
)

torch.set_num_threads(1)

n, NZ, DT, PTOP = 12, 8, 900.0, 300.0
# float64 through 6 substeps + remap: the operators agree to ~1e-15 each
# (vjp transposes and cumulative sums are ordered differently); w, a small
# residual of cancelling pressure terms, amplifies that to ~1e-11 of its
# magnitude (measured 3.8e-12), so 1e-9 of each field's magnitude
RTOL = 1e-9


@pytest.fixture(scope="module")
def jax_run():
    delp, pt, u, v, q = benchmark_like_state(n, NZ, seed=0)
    phis = 2000.0 * np.abs(np.random.RandomState(1).randn(6, n, n))
    run, m, _ = jhydro.make_dycore_stepper(
        JGrid.make(n, halo=3), NZ, DT, k_split=1, n_split=6, hord=5,
        kord=9, ptop=PTOP, dtype=jnp.float64,
    )
    st = jhydro.add_nonhydrostatic_fields(
        jhydro.DycoreState(*(jnp.asarray(a) for a in (delp, pt, u, v, q))),
        PTOP,
    )
    out = run(st, jnp.asarray(phis), 1)
    arrays = lambda s: {  # noqa: E731
        k: np.asarray(x) for k, x in s._asdict().items()
    }
    return arrays(st), phis, jax_metrics_arrays(m), arrays(out)


def _compare(out, want):
    got = state_to_numpy(out)
    for k, w in want.items():
        assert_close_scaled(got[k], w, RTOL, name=k)


def test_one_dt_matches_jax_with_jax_metrics(jax_run):
    state, phis, metrics, want = jax_run
    m = metrics_from_numpy(metrics)
    ak, bk = thydro.hybrid_coefficients(NZ, PTOP)
    one_dt = thydro.build_one_dt(
        m, ak, bk, NZ, DT, 1, 6, 5, 9, 0.12, PTOP, torch.float64
    )
    _compare(one_dt(state_from_numpy(state), torch.as_tensor(phis)), want)


def test_one_dt_matches_jax_with_own_metrics(jax_run):
    state, phis, _, want = jax_run
    run, m, _ = thydro.make_dycore_stepper(
        TGrid.make(n, halo=3), NZ, DT, k_split=1, n_split=6, hord=5,
        kord=9, ptop=PTOP, dtype=torch.float64, device="cpu",
    )
    assert m.area_px.dtype == torch.float64
    _compare(run(state_from_numpy(state), torch.as_tensor(phis), 1), want)


def test_add_nonhydrostatic_fields_matches_jax(jax_run):
    state, _, _, _ = jax_run
    base = {k: state[k] for k in ("delp", "pt", "u", "v", "q")}
    got = thydro.add_nonhydrostatic_fields(state_from_numpy(base), PTOP)
    np.testing.assert_allclose(got.delz.numpy(), state["delz"], rtol=1e-14)
    assert not bool(got.w.any())


def test_rest_state_matches_graft_entry():
    from __graft_entry__ import _rest_state

    want = _rest_state(JGrid.make(6, halo=3), 10, PTOP, jnp.float32)
    got = thydro.rest_state(6, 10, PTOP)
    for k in ("delp", "pt", "u", "v", "q"):
        np.testing.assert_array_equal(
            getattr(got, k).numpy(), np.asarray(getattr(want, k)), err_msg=k
        )


def test_other_substep_schemes_raise():
    with pytest.raises(NotImplementedError):
        thydro.dyn_substep(None, None, 1.0, PTOP, 5, 0.12, None,
                           None, None, None, None, c_half=False)


DATA = os.path.join(os.path.dirname(__file__), "data", "c12_trajectory.npz")


def _c12x63_trajectory():
    """2 steps of 900 s of the port at C12 x 63, float64, from the stored
    trajectory's initial state (numpy arrays)."""
    nz = 63
    delp, pt, u, v, q = benchmark_like_state(12, nz, seed=0)
    run, _, _ = thydro.make_dycore_stepper(
        TGrid.make(12, halo=3), nz, DT, k_split=1, n_split=6, hord=5,
        dtype=torch.float64,
    )
    st = thydro.add_nonhydrostatic_fields(
        thydro.DycoreState(*(torch.as_tensor(a) for a in (delp, pt, u, v, q))),
        PTOP,
    )
    return state_to_numpy(
        run(st, torch.zeros(6, 12, 12, dtype=torch.float64), 2)
    )


def _assert_matches_stored(got):
    want = np.load(DATA)
    for k in ("delp", "pt", "u", "v", "q", "w", "delz"):
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(
            got[k].astype(np.float32), want[k], rtol=2e-5,
            atol=2e-5 * max(scale, 1e-30), err_msg=f"trajectory drift in {k}",
        )


def test_c12_trajectory_matches_stored():
    """The port alone reproduces the JAX package's stored trajectory
    (C12 x 63, 2 steps of 900 s, float64), with the stored test's
    tolerances (test_regression_trajectory.py:88-91)."""
    _assert_matches_stored(_c12x63_trajectory())


def test_c12x63_fused_transport_equals_unfused_and_stored():
    """At C12 x 63 the steps with set_fused_transport(True) equal the
    unfused steps bit for bit on the CPU, and so reproduce the stored JAX
    trajectory."""
    from fv3net_tpu_torch.ops import advection

    off = _c12x63_trajectory()
    advection.set_fused_transport(True)
    try:
        on = _c12x63_trajectory()
    finally:
        advection.set_fused_transport(False)
    for k in off:
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)
    _assert_matches_stored(on)


def test_fused_transport_dt_equals_unfused_and_jax(jax_run):
    """One dt with set_fused_transport(True) equals the dt with it off,
    bit for bit on the CPU (the plain fused form is the five plain
    transports), and the JAX dt (which never fuses on the CPU)."""
    from fv3net_tpu_torch.ops import advection

    state, phis, metrics, want = jax_run
    m = metrics_from_numpy(metrics)
    ak, bk = thydro.hybrid_coefficients(NZ, PTOP)
    one_dt = thydro.build_one_dt(
        m, ak, bk, NZ, DT, 1, 6, 5, 9, 0.12, PTOP, torch.float64
    )
    off = one_dt(state_from_numpy(state), torch.as_tensor(phis))
    advection.set_fused_transport(True)
    try:
        on = one_dt(state_from_numpy(state), torch.as_tensor(phis))
    finally:
        advection.set_fused_transport(False)
    for k in off._fields:
        assert torch.equal(getattr(on, k), getattr(off, k)), k
    _compare(on, want)


def _smooth_lagrangian_state(n, nz, seed):
    """Smooth fields on Lagrangian layers that have drifted from the
    hybrid coordinate (numpy float64): the remap has work to do and no
    limiter sits on a rounding tie."""
    from fv3net_tpu.dycore.hydro import hybrid_coefficients

    ak, bk = (np.asarray(c) for c in hybrid_coefficients(nz, PTOP))
    pe = ak[:, None, None] + bk[:, None, None] * 1e5
    k = np.arange(nz)[None, :, None, None]
    rng = np.random.RandomState(seed)
    y, x = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n),
                       indexing="ij")
    ph = rng.rand(6)[:, None, None, None]
    delp = (pe[1:] - pe[:-1])[None] * (
        1.0 + 0.05 * np.sin(0.3 * k + 2.0 * x + ph)
    )
    pt = 250.0 + 2.0 * k + 5.0 * np.cos(0.2 * k + 3.0 * y + ph)
    u = 10.0 * np.sin(0.25 * k + 2.0 * np.linspace(0, 1, n + 1)[:, None]
                      + ph)
    v = 8.0 * np.cos(0.15 * k + 2.0 * np.linspace(0, 1, n + 1)[None, :]
                     + ph)
    q = 1e-3 * (1.5 + np.sin(0.1 * k + x + y + ph))[None]
    w = 0.5 * np.sin(0.4 * k + 4.0 * y + ph)
    delz = -(50.0 + 2.0 * k + np.cos(x + y + ph)) * np.ones_like(delp)
    b = lambda a, s: np.broadcast_to(a, s).copy()  # noqa: E731
    return (b(delp, (6, nz, n, n)), b(pt, (6, nz, n, n)),
            b(u, (6, nz, n + 1, n)), b(v, (6, nz, n, n + 1)),
            b(q, (1, 6, nz, n, n)), b(w, (6, nz, n, n)),
            b(delz, (6, nz, n, n)))


def test_remap_step_four_kords_matches_jax():
    """remap_step with four distinct kords (pt 9, winds 10, tracers 17,
    w/delz 7 through ppm_profile) against the JAX package's remap_step."""
    from fv3net_tpu.dycore.hydro import hybrid_coefficients

    arrays = _smooth_lagrangian_state(n, NZ, seed=5)
    ak, bk = hybrid_coefficients(NZ, PTOP)
    kords = dict(kord_tm=9, kord_mt=10, kord_tr=17, kord_wz=7)
    want = jhydro.remap_step(
        jhydro.DycoreState(*(jnp.asarray(a) for a in arrays)), ak, bk, PTOP,
        **kords,
    )
    got = thydro.remap_step(
        thydro.DycoreState(*(torch.as_tensor(a) for a in arrays)),
        torch.as_tensor(np.array(ak)), torch.as_tensor(np.array(bk)),
        PTOP, **kords,
    )
    for k in got._fields:
        assert_close_scaled(getattr(got, k).numpy(),
                            np.asarray(getattr(want, k)), 1e-12, name=k)
