"""fv3net_tpu_torch ops.advection (plain path of K1) against the JAX
package's jnp fv_tp_2d / ppm_flux and its Pallas kernel in interpret
mode, float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu.ops import advection as jadv
from fv3net_tpu.ops.pallas_tp import fv_tp_2d_pallas
from fv3net_tpu_torch.ops import advection as tadv

torch.set_num_threads(1)

n, H, NZ = 12, 3, 4
N = n + 2 * H
# the caller consumes faces [2, N-2): roll() leaves garbage near the ends
SL = np.s_[:, :, 2 : N - 2, 2 : N - 2]
# f64, same operations in the same order: only summation-free rounding
# differences (e.g. the fused q*area products) remain
RTOL = 1e-12


def _inputs(seed, mass_weighted):
    rng = np.random.RandomState(seed)
    sh = (6, NZ, N, N)
    area = 1.0 + 0.1 * rng.rand(6, 1, N, N)
    args = [
        rng.randn(*sh), rng.randn(*sh),  # qx, qy
        0.2 * rng.randn(*sh), 0.2 * rng.randn(*sh),  # crx, cry
        0.05 * area * rng.randn(*sh), 0.05 * area * rng.randn(*sh),
    ]
    if mass_weighted:  # area * delp, the pt/w/tracer transport form
        dp = 100.0 + rng.rand(*sh)
        args += [area * dp, area * dp]
    else:
        args += [area, area.copy()]
    return args


def _close(got, want):
    np.testing.assert_allclose(
        got.numpy()[SL], np.asarray(want)[SL], rtol=RTOL, atol=RTOL
    )


@pytest.mark.parametrize("mass_weighted", [False, True])
@pytest.mark.parametrize("hord", [1, 5, 6, 8])
def test_fv_tp_2d_matches_jnp(hord, mass_weighted):
    args = _inputs(hord, mass_weighted)
    want = jadv.fv_tp_2d(*[jnp.asarray(a) for a in args], hord)
    got = tadv.fv_tp_2d(*[torch.as_tensor(a) for a in args], hord)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("mass_weighted", [False, True])
@pytest.mark.parametrize("hord", [1, 5, 6, 8])
def test_fv_tp_2d_matches_pallas_interpret(hord, mass_weighted):
    """The TPU kernel (interpret mode) computes what the port computes."""
    args = _inputs(10 + hord, mass_weighted)
    want = fv_tp_2d_pallas(
        *[jnp.asarray(a) for a in args], hord, interpret=True
    )
    got = tadv.fv_tp_2d(*[torch.as_tensor(a) for a in args], hord)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("hord", [1, 5, 6, 8])
def test_ppm_flux_matches_jnp(hord, axis):
    rng = np.random.RandomState(hord)
    q = rng.randn(6, NZ, N, N)
    cr = 0.4 * rng.randn(6, NZ, N, N)
    want = jadv.ppm_flux(jnp.asarray(q), jnp.asarray(cr), axis, hord)
    got = tadv.ppm_flux(torch.as_tensor(q), torch.as_tensor(cr), axis, hord)
    _close(got, want)


def test_unsupported_hord_raises():
    q = torch.zeros(6, 1, N, N, dtype=torch.float64)
    with pytest.raises(ValueError):
        tadv.ppm_flux(q, q, -1, 3)


@pytest.mark.parametrize("hord", [1, 5, 6, 8])
def test_fv_tp_2d_single_layer_matches_pallas_interpret(hord):
    """The single-layer (shallow-water) form: [F, N, N] fields and
    [F, N, N] areas, as the JAX kernel takes them (pallas_tp.py:270-276),
    give [F, N, N] fluxes equal to the JAX package's (its kernel in
    interpret mode and its jnp form) and to the port's [F, 1, N, N]
    form."""
    args = [a[:, 0] for a in _inputs(20 + hord, False)]
    got = tadv.fv_tp_2d(*[torch.as_tensor(a) for a in args], hord)
    layered = tadv.fv_tp_2d(*[torch.as_tensor(a)[:, None] for a in args],
                            hord)
    for want in (
        fv_tp_2d_pallas(*[jnp.asarray(a) for a in args], hord,
                        interpret=True),
        jadv.fv_tp_2d(*[jnp.asarray(a) for a in args], hord),
    ):
        for g, w, g4 in zip(got, want, layered):
            assert g.shape == (6, N, N)
            _close(g[:, None], np.asarray(w)[:, None])
            assert torch.equal(g, g4[:, 0])
