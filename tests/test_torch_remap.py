"""fv3net_tpu_torch ops.remap against the JAX package's ops/remap.py and
the scalar mappm oracle (tests/reference_mappm.py), float64 on the CPU:
cs_profile for kord 8-17 and iv -2..2, ppm_profile for kord <= 7 and
negative kords, and ppm_remap with either boundary rule.

Strict comparisons in the limiters sit at exact equality for clamped
profiles, so a 1-ulp difference between two correct implementations
(XLA and torch round a few expressions differently) flips a branch
there; as in tests/test_remap.py, profiles are compared outside the
cells the oracle flags as such ties, and the remap itself on smooth
columns, where no tie sits near a branch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu.ops import remap as jremap
from fv3net_tpu_torch.ops import remap as tremap
from reference_mappm import (
    cs_profile_ref,
    mappm_ref,
    ppm_profile_ref,
)
from test_remap import _assert_profile_close, _edges, random_columns

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
    # f64; the integral is summed per layer overlap here and cumulatively
    # in the JAX package
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
    out = tremap.ppm_remap(*(torch.as_tensor(a) for a in (q, pe1, pe2)),
                           kord=9, exact_boundaries=True)
    m1 = (q * (pe1[1:] - pe1[:-1])).sum(0)
    m2 = (out.numpy() * (pe2[1:] - pe2[:-1])).sum(0)
    np.testing.assert_allclose(m2, m1, rtol=1e-12)


def _profiles(fn_port, fn_jax, q, dp, *args, **kw):
    """(port, JAX) profiles of q, dp [ncol, km] as [ncol, km] arrays."""
    got = fn_port(torch.as_tensor(q.T.copy()), torch.as_tensor(dp.T.copy()),
                  *args, **{k: torch.as_tensor(v) for k, v in kw.items()})
    want = fn_jax(jnp.asarray(q.T), jnp.asarray(dp.T), *args,
                  **{k: jnp.asarray(v) for k, v in kw.items()})
    return ([g.numpy().T for g in got], [np.asarray(w).T for w in want])


@pytest.mark.parametrize("kord", [8, 9, 10, 11, 12, 13, 14, 15, 16, 17])
@pytest.mark.parametrize("iv", [-1, 0, 1, 2])
def test_cs_profile_matches_jax_and_oracle(kord, iv):
    ncol, km = 12, 24
    q, dp = random_columns(ncol, km, seed=kord * 10 + iv)
    if iv == 0:
        q = np.abs(q)
    got, want = _profiles(tremap.cs_profile, jremap.cs_profile, q, dp, iv,
                          kord)
    for i in range(ncol):
        *ref, tie = cs_profile_ref(q[i], dp[i], iv, kord, return_ties=True)
        mine = [g[i] for g in got]
        what = f"cs_profile kord={kord} iv={iv} col={i}"
        _assert_profile_close(mine, [w[i] for w in want], tie, what)
        _assert_profile_close(mine, ref, tie, what + " (oracle)")


@pytest.mark.parametrize("kord", [9, 10, 17])
def test_cs_profile_iv_minus2_matches_jax_and_oracle(kord):
    ncol, km = 8, 16
    q, dp = random_columns(ncol, km, seed=5 + kord)
    qs = np.random.RandomState(6).randn(ncol)
    got, want = _profiles(tremap.cs_profile, jremap.cs_profile, q, dp, -2,
                          kord, qs=qs)
    for i in range(ncol):
        *ref, tie = cs_profile_ref(q[i], dp[i], -2, kord, qs=qs[i],
                                   return_ties=True)
        mine = [g[i] for g in got]
        # the oracle's a6 for iv = -2 is not comparable (test_remap.py:93)
        _assert_profile_close(mine, [w[i] for w in want], tie,
                              f"iv=-2 kord={kord} col={i}")
        _assert_profile_close(mine[:2], ref[:2], tie,
                              f"iv=-2 kord={kord} col={i} (oracle)")


@pytest.mark.parametrize("kord", [1, 4, 5, 6, 7, -10])
@pytest.mark.parametrize("iv", [-1, 0, 1])
def test_ppm_profile_matches_jax_and_oracle(kord, iv):
    ncol, km = 10, 20
    q, dp = random_columns(ncol, km, seed=100 + kord + iv)
    if iv == 0:
        q = np.abs(q)
    got, want = _profiles(tremap.ppm_profile, jremap.ppm_profile, q, dp, iv,
                          kord)
    for i in range(ncol):
        *ref, tie = ppm_profile_ref(q[i], dp[i], iv, kord, return_ties=True)
        mine = [g[i] for g in got]
        what = f"ppm_profile kord={kord} iv={iv} col={i}"
        _assert_profile_close(mine, [w[i] for w in want], tie, what)
        _assert_profile_close(mine, ref, tie, what + " (oracle)")


@pytest.mark.parametrize("iv", [2, -2])
@pytest.mark.parametrize("kord", [4, 7])
def test_ppm_profile_iv2_matches_jax(kord, iv):
    """iv = +-2 of ppm_profile (the oracle has no such variant)."""
    q, dp = random_columns(6, 18, seed=40 + kord + iv, smooth=True)
    got, want = _profiles(tremap.ppm_profile, jremap.ppm_profile, q, dp, iv,
                          kord)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("kord", [1, 7, 9, 10, 12, 17, -10])
def test_ppm_remap_matches_jax(kord, exact):
    """The whole remap on smooth columns, target edges extending past
    both ends of the source column (both boundary rules fire)."""
    ncol, km, kn = 8, 20, 17
    q, _ = random_columns(ncol, km, seed=21, smooth=True)
    pe1 = _edges(ncol, km, 100.0, 1000.0, seed=22)
    pe2 = _edges(ncol, kn, 80.0, 1050.0, seed=23)
    args = (q.T.copy(), pe1.T.copy(), pe2.T.copy())
    want = jremap.ppm_remap(*(jnp.asarray(a) for a in args), iv=1,
                            kord=kord, exact_boundaries=exact)
    got = tremap.ppm_remap(*(torch.as_tensor(a) for a in args), iv=1,
                           kord=kord, exact_boundaries=exact)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


def test_ppm_remap_iv_minus2_with_qs_matches_jax():
    ncol, km, kn = 6, 16, 14
    q, _ = random_columns(ncol, km, seed=31, smooth=True)
    qs = np.random.RandomState(32).randn(ncol)
    pe1 = _edges(ncol, km, 100.0, 1000.0, seed=33)
    pe2 = _edges(ncol, kn, 100.0, 1000.0, seed=34)
    args = (q.T.copy(), pe1.T.copy(), pe2.T.copy())
    want = jremap.ppm_remap(*(jnp.asarray(a) for a in args), iv=-2, kord=9,
                            qs=jnp.asarray(qs))
    got = tremap.ppm_remap(*(torch.as_tensor(a) for a in args), iv=-2,
                           kord=9, qs=torch.as_tensor(qs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("kord", [1, 7, 9, 10])
@pytest.mark.parametrize("iv", [0, 1])
def test_remap_integration_matches_oracle(kord, iv):
    """The integration (mappm's rules, exact_boundaries=False) against the
    oracle's interval-by-interval accumulation with the port's own
    reconstruction, so limiter ties cannot flip the comparison
    (test_remap.py:143-171)."""
    ncol, km, kn = 8, 20, 17
    q, _ = random_columns(ncol, km, seed=3, smooth=True)
    if iv == 0:
        q = np.abs(q)
    pe1 = _edges(ncol, km, 100.0, 1000.0, seed=4)
    pe2 = _edges(ncol, kn, 80.0, 1050.0, seed=5)
    t = torch.as_tensor
    q2 = tremap.ppm_remap(t(q.T.copy()), t(pe1.T.copy()), t(pe2.T.copy()),
                          iv=iv, kord=kord).numpy().T
    dp1 = np.diff(pe1, axis=1)
    prof = [p.numpy().T for p in tremap._reconstruct(
        t(q.T.copy()), t(dp1.T.copy()), iv, kord, None
    )]
    for i in range(ncol):
        want = mappm_ref(q[i], pe1[i], pe2[i], iv, kord,
                         profile=[p[i] for p in prof])
        np.testing.assert_allclose(q2[i], want, rtol=1e-9, atol=1e-10)


def test_remap_float32_close_to_float64():
    """The per-overlap integration keeps a float32 remap within 1e-5 of
    the field's magnitude of the float64 remap of the same (f32-rounded)
    columns, whose target layers can be a few Pa thin (sorted uniform
    edges, km = 63; measured <= 5e-6); the cumulative form of the JAX
    package loses |M| * eps / dp2 there (1.7e-2 at km = 13)."""
    q, pe1, pe2 = _columns(63, 63, seed=0)
    a32 = [torch.as_tensor(a).float() for a in (q, pe1, pe2)]
    want = tremap.ppm_remap(*(a.double() for a in a32), kord=9,
                            exact_boundaries=True)
    got = tremap.ppm_remap(*a32, kord=9, exact_boundaries=True)
    err = float((got.double() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize(
    "iv,kord,covered",
    [(1, 9, True), (0, 10, True), (-1, 17, True), (1, 40, True),
     (1, -9, False), (1, -17, False), (-2, 9, False), (2, 9, False),
     (1, 8, False), (1, 12, False), (1, 7, False)],
)
def test_kernel_covers(iv, kord, covered):
    assert tremap.kernel_covers(iv, kord) is covered
