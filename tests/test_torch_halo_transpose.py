"""The gather-form transposes of the staggered halo exchanges
(fv3net_tpu_torch/grid/halo_transpose.py): equal to autograd's
scatter-add transpose of the plain gather and to the JAX package's
linear-primitive transpose, to float64 roundoff; forward mode still works;
the dampers built on them are unchanged; and their vjp dispatches no
scatter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fv3net_tpu.grid import halo as jhalo
from fv3net_tpu_torch.dycore import sw as tsw
from fv3net_tpu_torch.grid import CubedSphereGrid as TGrid
from fv3net_tpu_torch.grid import halo as thalo
from fv3net_tpu_torch.grid import halo_transpose as ht

torch.set_num_threads(1)

N, H, NZ = 8, 3, 2
# float64 roundoff: the transposes sum up to K = 5 terms per entry in
# another order than autograd's scatter-add and XLA's transpose
ATOL = 1e-13

KINDS = {
    # kind, fill, stored shapes (a, b), public exchange
    "dgrid": ("dgrid", "", ((N + 1, N), (N, N + 1)),
              lambda mod, a, b: mod.halo_exchange_dgrid(a, b, H)),
    "cgrid-x": ("cgrid", "x", ((N, N + 1), (N + 1, N)),
                lambda mod, a, b: mod.halo_exchange_cgrid(a, b, H, "x")),
    "cgrid-y": ("cgrid", "y", ((N, N + 1), (N + 1, N)),
                lambda mod, a, b: mod.halo_exchange_cgrid(a, b, H, "y")),
}


def _inputs(name, seed):
    _, _, (sa, sb), _ = KINDS[name]
    rng = np.random.RandomState(seed)
    return rng.randn(6, NZ, *sa), rng.randn(6, NZ, *sb)


@pytest.mark.parametrize("name", sorted(KINDS))
def test_transpose_matches_autograd_and_jax(name):
    kind, fill, _, public = KINDS[name]
    a, b = _inputs(name, 0)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    out, vjp_new = torch.func.vjp(lambda x, y: public(thalo, x, y), ta, tb)
    plain, vjp_old = torch.func.vjp(
        lambda x, y: thalo._staggered_exchange(x, y, kind, H, fill), ta, tb
    )
    for o, p in zip(out, plain):  # the forward is the plain gather
        assert torch.equal(o, p)
    rng = np.random.RandomState(1)
    ct = tuple(rng.randn(*o.shape) for o in out)
    got = vjp_new(tuple(torch.as_tensor(c) for c in ct))
    old = vjp_old(tuple(torch.as_tensor(c) for c in ct))
    _, vjp_jax = jax.vjp(
        lambda x, y: public(jhalo, x, y), jnp.asarray(a), jnp.asarray(b)
    )
    want = vjp_jax(tuple(jnp.asarray(c) for c in ct))
    for g, o, w in zip(got, old, want):
        assert g.shape == o.shape
        np.testing.assert_allclose(g.numpy(), o.numpy(), rtol=0, atol=ATOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("name", sorted(KINDS))
def test_inverse_tables_cover_the_pool(name):
    """Every pool entry is read (at least by its own slot); only the
    band within a few cells of the face edges has more readers."""
    kind, fill, _, _ = KINDS[name]
    n = 24
    ra, ca, rb, cb = ht._pool_shapes(kind, n)
    direct, _, _, bs, K, E = ht._inverse_tables(kind, n, H, fill)
    P = ra * ca + rb * cb
    Q = (ra + 2 * H) * (ca + 2 * H) + (rb + 2 * H) * (cb + 2 * H)
    assert direct.shape == (6, P) and K <= 5 and E < P / 2
    band = direct >= Q  # entries whose cotangent is a band sum
    has_reader = np.abs(bs.reshape(6, K, E)).sum(axis=1) > 0
    for g in range(6):
        # the band entries of face g are the first of its E band slots,
        # each with a reader; the rest are padding without one
        e = np.sort(direct[g][band[g]] - Q)
        np.testing.assert_array_equal(e, np.arange(band[g].sum()))
        assert has_reader[g, : e.size].all()
        assert not has_reader[g, e.size :].any()
        assert (direct[g][~band[g]] < Q).all()


def test_jacfwd_and_vmap_through_the_exchange():
    """Forward mode: the Jacobian of the (linear) exchange applied to a
    vector is the exchange of that vector; vmap batches it."""
    n = 4
    rng = np.random.RandomState(2)
    u = torch.as_tensor(rng.randn(6, n + 1, n))
    v = torch.as_tensor(rng.randn(6, n, n + 1))
    x = torch.as_tensor(rng.randn(6, n + 1, n))
    jac = torch.func.jacfwd(
        lambda uu: thalo.halo_exchange_dgrid(uu, v, H)[0]
    )(u)
    got = (jac.reshape(-1, u.numel()) @ x.reshape(-1)).reshape(
        6, n + 2 * H + 1, n + 2 * H
    )
    want = thalo._staggered_exchange(x, torch.zeros_like(v), "dgrid", H, "")
    torch.testing.assert_close(got, want[0], rtol=0, atol=1e-14)

    def f(eps):  # tests/test_halo_transpose.py::test_jacfwd_still_works
        up, vp = thalo.halo_exchange_dgrid(u + eps, v, H)
        return (up ** 2).sum() + vp.sum()

    g = torch.func.jacfwd(f)(torch.tensor(0.0, dtype=torch.float64))
    assert torch.isfinite(g)
    batch = torch.stack([u, 2.0 * u])
    out = torch.func.vmap(lambda uu: thalo.halo_exchange_dgrid(uu, v, H))(
        batch
    )
    for i in range(2):
        want = thalo._staggered_exchange(batch[i], v, "dgrid", H, "")
        assert torch.equal(out[0][i], want[0])
        assert torch.equal(out[1][i], want[1])


@pytest.fixture(scope="module")
def metrics():
    return tsw.SWMetrics.make(TGrid.make(N, halo=H), torch.float64,
                              device="cpu")


@pytest.mark.parametrize("damper", ["div_damp", "corner_div_damp"])
def test_dampers_unchanged(metrics, damper, monkeypatch):
    """The dampers through the gather transposes equal the dampers
    through autograd's transpose of the plain gather."""
    rng = np.random.RandomState(3)
    u = torch.as_tensor(rng.randn(6, NZ, N + 1, N))
    v = torch.as_tensor(rng.randn(6, NZ, N, N + 1))
    c = 0.12 if damper == "div_damp" else tsw.CORNER_DAMP_COEF
    got = getattr(tsw, damper)(u, v, metrics, c)
    monkeypatch.setattr(
        tsw, "halo_exchange_dgrid",
        lambda a, b, h: thalo._staggered_exchange(a, b, "dgrid", h, ""),
    )
    want = getattr(tsw, damper)(u, v, metrics, c)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-12 * float(w.abs().max()))
    # dissipative: the damper never adds wind "energy"
    assert float((u * got[0]).sum() + (v * got[1]).sum()) <= 1e-10


SCATTERS = ("index_put", "index_add", "scatter")


@pytest.mark.parametrize("name", sorted(KINDS))
def test_vjp_dispatches_no_scatter(name):
    """The reverse pass of the exchanges is gathers only: no
    index_put_(accumulate=True), index_add or scatter_add."""
    a, b = (torch.as_tensor(x) for x in _inputs(name, 4))
    out, vjp_fn = torch.func.vjp(
        lambda x, y: KINDS[name][3](thalo, x, y), a, b
    )
    ct = tuple(torch.ones_like(o) for o in out)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        vjp_fn(ct)
    ops = {e.name for e in prof.events()}
    assert "aten::gather" in ops or "aten::index" in ops, ops
    bad = sorted(o for o in ops if any(s in o for s in SCATTERS))
    assert not bad, bad
