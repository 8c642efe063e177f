"""fv3net_tpu_torch dycore.riemann (plain path of K2) against the JAX
package's jnp sim1_solver and its Pallas kernel in interpret mode,
float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu.dycore import riemann as jr
from fv3net_tpu.ops.pallas_sim1 import sim1_solver_pallas
from fv3net_tpu_torch.dycore import riemann as tr

torch.set_num_threads(1)

# f64: the same recurrences in the same order; differences are roundoff
# of the level recurrences (~1e-15 relative), bounded with margin
RTOL = 1e-11


def _columns(n=6, nz=13, seed=0):
    """Physically plausible columns (the gas law needs dz < 0, dm > 0,
    pt > 0), as numpy float64."""
    rng = np.random.RandomState(seed)
    pe = np.sort(
        np.linspace(300.0, 1.0e5, nz + 1)[:, None, None]
        * (1.0 + 0.01 * rng.rand(6, nz + 1, n, n)),
        axis=1,
    )
    delp = pe[:, 1:] - pe[:, :-1]
    pt = np.clip(300.0 + 30.0 * rng.randn(6, nz, n, n), 200.0, 400.0)
    pm = np.array(jr.layer_mean_pressure(jnp.asarray(delp), jnp.asarray(pe)))
    dz = np.asarray(
        jr.hydrostatic_dz(jnp.asarray(delp), jnp.asarray(pt), jnp.asarray(pe))
    ) * (1.0 + 0.05 * rng.randn(6, nz, n, n))
    w = 2.0 * rng.randn(6, nz, n, n)
    ws = 0.5 * rng.randn(6, n, n)
    return [delp / 9.80665, pt, dz, w, pe, pm, ws]


def _scaled(got, want):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= RTOL * np.abs(want).max(), err


@pytest.mark.parametrize("reference", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("nz", [2, 13])
def test_sim1_solver_matches(reference, nz):
    args = _columns(nz=nz, seed=nz)
    dt = 150.0
    jargs = [jnp.asarray(a) for a in args]
    if reference == "jnp":
        want = jr.sim1_solver(dt, *jargs)
    else:
        want = sim1_solver_pallas(dt, *jargs, interpret=True)
    got = tr.sim1_solver(dt, *[torch.as_tensor(a) for a in args])
    for g, w in zip(got, want):
        _scaled(g, w)


def test_sim1_solve_dispatch_cpu_is_plain():
    args = [torch.as_tensor(a) for a in _columns(seed=3)]
    for g, w in zip(tr.sim1_solve(100.0, *args),
                    tr.sim1_solver(100.0, *args)):
        assert torch.equal(g, w)


def test_hydrostatic_dz_and_layer_mean_pressure():
    rng = np.random.RandomState(4)
    pe = np.sort(300.0 + 1e5 * rng.rand(6, 9, 5, 5), axis=1)
    delp = pe[:, 1:] - pe[:, :-1]
    pt = 250.0 + 50.0 * rng.rand(6, 8, 5, 5)
    want = jr.hydrostatic_dz(*(jnp.asarray(a) for a in (delp, pt, pe)))
    got = tr.hydrostatic_dz(*(torch.as_tensor(a) for a in (delp, pt, pe)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)
    want = jr.layer_mean_pressure(jnp.asarray(delp), jnp.asarray(pe))
    got = tr.layer_mean_pressure(torch.as_tensor(delp), torch.as_tensor(pe))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)


def test_gas_law_round_trip():
    rng = np.random.RandomState(5)
    dm = torch.as_tensor(100.0 + rng.rand(3, 4))
    pt = torch.as_tensor(280.0 + 20.0 * rng.rand(3, 4))
    p = torch.as_tensor(5e4 + 1e4 * rng.rand(3, 4))
    dz = tr.dz_from_pressure(dm, pt, p)
    assert bool((dz < 0).all())
    np.testing.assert_allclose(
        tr.full_pressure(dm, pt, dz).numpy(), p.numpy(), rtol=1e-12
    )
