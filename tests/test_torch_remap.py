"""fv3net_tpu_torch ops.remap.ppm_remap (kord 9, exact boundaries, the
dycore's case) against the JAX package's ppm_remap, float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu.ops import remap as jremap
from fv3net_tpu_torch.ops import remap as tremap

torch.set_num_threads(1)


def _columns(km, kn, seed, stag=(0, 0)):
    """Source/target edges sharing the column's end points (the
    Lagrangian -> Eulerian situation), [k, 6, Y, X] k-leading."""
    rng = np.random.RandomState(seed)
    ny, nx = 5 + stag[0], 5 + stag[1]
    pe1 = np.sort(
        np.linspace(300.0, 1.0e5, km + 1)[:, None, None, None]
        * (1.0 + 0.02 * rng.rand(km + 1, 6, ny, nx)),
        axis=0,
    )
    w = np.sort(rng.rand(kn + 1, 6, ny, nx), axis=0)
    w = (w - w[:1]) / (w[-1:] - w[:1])
    pe2 = pe1[:1] + (pe1[-1:] - pe1[:1]) * w
    q = 1.0 + rng.randn(km, 6, ny, nx)
    return q, pe1, pe2


@pytest.mark.parametrize("stag", [(0, 0), (1, 0)])
@pytest.mark.parametrize("iv", [1, 0, -1])
def test_ppm_remap_kord9_matches_jax(iv, stag):
    q, pe1, pe2 = _columns(13, 13, seed=iv + 5, stag=stag)
    want = jremap.ppm_remap(
        jnp.asarray(q), jnp.asarray(pe1), jnp.asarray(pe2), iv=iv, kord=9,
        exact_boundaries=True,
    )
    got = tremap.ppm_remap(
        torch.as_tensor(q), torch.as_tensor(pe1), torch.as_tensor(pe2),
        iv=iv, kord=9, exact_boundaries=True,
    )
    # f64; the cumulative-mass sum over k is ordered differently
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("iv", [1, 0, -1])
def test_cs_profile_kord9_matches_jax(iv):
    q, pe1, _ = _columns(11, 11, seed=20 + iv)
    dp = pe1[1:] - pe1[:-1]
    want = jremap.cs_profile(jnp.asarray(q), jnp.asarray(dp), iv, 9)
    got = tremap.cs_profile(torch.as_tensor(q), torch.as_tensor(dp), iv, 9)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)


def test_ppm_remap_conserves_mass():
    q, pe1, pe2 = _columns(20, 16, seed=3)
    out = tremap.ppm_remap(*(torch.as_tensor(a) for a in (q, pe1, pe2)))
    m1 = (q * (pe1[1:] - pe1[:-1])).sum(0)
    m2 = (out.numpy() * (pe2[1:] - pe2[:-1])).sum(0)
    np.testing.assert_allclose(m2, m1, rtol=1e-12)


@pytest.mark.parametrize(
    "kw", [dict(kord=10), dict(kord=5), dict(iv=-2), dict(iv=2),
           dict(exact_boundaries=False)],
)
def test_unported_variants_raise(kw):
    q, pe1, pe2 = (torch.as_tensor(a) for a in _columns(8, 8, seed=1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tremap.ppm_remap(q, pe1, pe2, **kw)
