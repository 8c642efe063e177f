"""The shared-boundary rewrites of fv3net_tpu_torch/grid/halo.py
(``canonicalize_cgrid_boundary``, ``average_dgrid_boundary``), which
gather only the 12n or 24n boundary slots a level, against their
full-pool form kept here as the plain reference: one partner gathered for
every slot of the pool and kept where the table's mask says.  The
arithmetic at each slot is the same, so the forward and the vjp are equal
bit for bit, and so are the dampers and the SW step built on them.  The
card's replayed dt is held against the same reference in
tests/test_torch_cuda.py."""

from functools import lru_cache

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fv3net_tpu_torch.dycore import sw as tsw
from fv3net_tpu_torch.grid import CubedSphereGrid
from fv3net_tpu_torch.grid import halo


# --- the plain reference: the full-pool form -------------------------------


@lru_cache(maxsize=None)
def _full_pool_tables(kind, n, device, dtype):
    """(face, pos, coef, mask) over every slot of the stored arrays' own
    shapes, [6, 1, P] each; unmasked slots read pool entry 0."""
    if kind == "canon":
        ia, ca, ma, ib, cb, mb = halo._cgrid_boundary_canon_tables(n)
        shape = (n, n + 1, n + 1, n)
    else:
        ia, ca, ma, ib, cb, mb = halo._dgrid_boundary_pair_tables(n)
        shape = (n + 1, n, n, n + 1)
    out = []
    for idx, coef, mask in ((ia, ca, ma), (ib, cb, mb)):
        face, pos = halo._decode_pool(idx.reshape(6, -1), *shape)

        def t(a, dt=None):
            return torch.as_tensor(np.asarray(a).reshape(6, 1, -1),
                                   dtype=dt, device=device)

        out.append((t(face, torch.int64), t(pos, torch.int64),
                    t(coef, dtype), t(mask)))
    return tuple(out)


def full_pool_boundary_partner(a, b, kind):
    """``halo._boundary_partner`` as a gather of a partner for every slot
    of the per-face pool [a | b] and a ``torch.where`` on the mask: the
    same flat outputs, and autograd's transpose of that gather."""
    n = a.shape[-1] if kind == "avg" else a.shape[-2]
    pool = torch.cat([a.reshape(6, -1, a.shape[-2] * a.shape[-1]),
                      b.reshape(6, -1, b.shape[-2] * b.shape[-1])], dim=-1)
    m = torch.arange(pool.shape[1], device=pool.device).view(1, -1, 1)
    outs = []
    for x, (fi, pi, cf, mk) in zip(
        (a, b), _full_pool_tables(kind, n, a.device, a.dtype)
    ):
        p = pool[fi, m, pi] * cf
        own = x.reshape(p.shape)
        if kind == "canon":
            o = torch.where(mk, p, own)
        else:
            o = torch.where(mk, 0.5 * (own + p), own)
        outs.append(o.reshape(-1))
    return outs


def use_full_pool_form(monkeypatch):
    monkeypatch.setattr(halo, "_boundary_partner",
                        full_pool_boundary_partner)


# --- the two boundary functions ---------------------------------------------

FUNCTIONS = {
    # public function, (a, b) stored shapes at n
    "canonicalize_cgrid_boundary": (
        halo.canonicalize_cgrid_boundary,
        lambda n: ((n, n + 1), (n + 1, n))),
    "average_dgrid_boundary": (
        halo.average_dgrid_boundary,
        lambda n: ((n + 1, n), (n, n + 1))),
}
DTYPES = {"float64": torch.float64, "float32": torch.float32}


def _pair(name, n, lead, dtype, seed):
    """A random stored pair, each a crop of a larger array (as the step
    passes them), so neither is contiguous."""
    rng = np.random.RandomState(seed)
    out = []
    for r, c in FUNCTIONS[name][1](n):
        big = torch.as_tensor(rng.randn(6, *lead, r + 3, c + 2),
                              dtype=dtype)
        out.append(big[..., 1 : 1 + r, 2 : 2 + c])
    return out


def _forward_and_vjp(name, a, b, seed):
    fn = FUNCTIONS[name][0]
    out, vjp_fn = torch.func.vjp(fn, a, b)
    rng = np.random.RandomState(seed)
    ct = tuple(torch.as_tensor(rng.randn(*o.shape), dtype=o.dtype)
               for o in out)
    return out, vjp_fn(ct)


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)], ids=str)
@pytest.mark.parametrize("n", [2, 6, 48])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_forward_and_vjp_equal_the_full_pool_form(name, dtype, n, lead,
                                                  monkeypatch):
    a, b = _pair(name, n, lead, DTYPES[dtype], seed=n)
    got = _forward_and_vjp(name, a, b, seed=n + 1)
    use_full_pool_form(monkeypatch)
    want = _forward_and_vjp(name, a, b, seed=n + 1)
    for part, g_, w_ in zip(("forward", "vjp"), got, want):
        for k, (g, w) in enumerate(zip(g_, w_)):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert torch.equal(g, w), (part, k, (g - w).abs().max())


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_jacfwd_and_vmap_equal_the_full_pool_form(name, monkeypatch):
    """Forward mode and vmap run through the compact form and give the
    full-pool form's Jacobian, entry for entry."""
    a, b = (x.contiguous() for x in _pair(name, 3, (2,), torch.float64, 5))
    fn = FUNCTIONS[name][0]

    def both():
        jac = torch.func.jacfwd(lambda x, y: fn(x, y), argnums=(0, 1))(a, b)
        batched = torch.func.vmap(fn)(torch.stack([a, 2 * a]),
                                      torch.stack([b, -b]))
        return [j for row in jac for j in row] + list(batched)

    got = both()
    use_full_pool_form(monkeypatch)
    want = both()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# --- the compact tables -----------------------------------------------------


@pytest.mark.parametrize("nz", [1, 4])
@pytest.mark.parametrize("n", [2, 6, 48])
@pytest.mark.parametrize("kind,per_edge", [("canon", 1), ("avg", 2)])
def test_compact_tables_hold_the_boundary_slots(kind, per_edge, n, nz):
    """12n replaced (canon) or 24n paired (avg) slots a level, each once,
    each with its own partner, the slots exactly the tables' masks."""
    tables = halo._boundary_gather(kind, n, nz, torch.device("cpu"),
                                   torch.float64)
    full = (halo._cgrid_boundary_canon_tables(n) if kind == "canon"
            else halo._dgrid_boundary_pair_tables(n))
    assert sum(t[0].numel() for t in tables) == 12 * per_edge * n * nz
    for k, (slot, from_a, from_b, cf) in enumerate(tables):
        assert slot.numel() == from_a.numel() + from_b.numel() == cf.numel()
        assert slot.unique().numel() == slot.numel()
        mask = np.asarray(full[3 * k + 2]).reshape(6, 1, -1)
        want = np.flatnonzero(np.broadcast_to(mask, (6, nz, mask.shape[-1])))
        np.testing.assert_array_equal(np.sort(slot.numpy()), want)
        assert set(np.unique(np.abs(cf.numpy()))) == {1.0}
    for j in (1, 2):  # partners in a, then in b: no entry read twice
        p = torch.cat([t[j] for t in tables])
        assert p.unique().numel() == p.numel()


SCATTERS = ("index_put", "index_add", "scatter")


def _scatter_lengths(prof):
    """The most entries one scatter the profiler saw wrote, by op name:
    the length of the index of index_add_ / scatter_add_(self, dim,
    index, src), that of the values of index_put_(self, indices, values)
    (their indices broadcast to it; the profiler gives a list of tensors
    no shape)."""
    out = {}
    for e in prof.events():
        if any(s in e.name for s in SCATTERS):
            length = int(np.prod(e.input_shapes[2]))
            out[e.name] = max(out.get(e.name, 0), length)
    return out


@pytest.mark.parametrize("form", ["compact", "full-pool"])
def test_vjp_scatters_only_the_boundary_slots(form, monkeypatch):
    """The vjp of canonicalize_cgrid_boundary scatters no index longer than
    12n x M (one term onto each partner); the full-pool form's scatters
    one for every slot, n(n+1) x 6 x M for each array."""
    n, M = 12, 4
    if form == "full-pool":
        use_full_pool_form(monkeypatch)
    uc, vc = _pair("canonicalize_cgrid_boundary", n, (M,), torch.float32, 7)
    out, vjp_fn = torch.func.vjp(halo.canonicalize_cgrid_boundary, uc, vc)
    ct = tuple(torch.ones_like(o) for o in out)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        vjp_fn(ct)
    lengths = _scatter_lengths(prof)
    assert lengths, "no scatter seen"
    if form == "compact":
        assert max(lengths.values()) <= 12 * n * M, lengths
    else:
        assert max(lengths.values()) == n * (n + 1) * 6 * M, lengths


# --- what is built on them --------------------------------------------------

N, H, NZ = 8, 3, 2


@pytest.fixture(scope="module")
def metrics():
    g = CubedSphereGrid.make(N, halo=H)
    return {k: tsw.SWMetrics.make(g, dt, device="cpu")
            for k, dt in DTYPES.items()}


def _winds(dtype, seed, lead=(NZ,)):
    rng = np.random.RandomState(seed)
    return (torch.as_tensor(10.0 * rng.randn(6, *lead, N + 1, N),
                            dtype=dtype),
            torch.as_tensor(10.0 * rng.randn(6, *lead, N, N + 1),
                            dtype=dtype))


def _built_on_them(case, dtype, m):
    if case == "div_damp":
        u, v = _winds(dtype, 11)
        return tsw.div_damp(u, v, m, 0.12)
    if case == "sw_step":
        u, v = _winds(dtype, 12, lead=())
        rng = np.random.RandomState(13)
        delp = torch.as_tensor(1000.0 + 10.0 * rng.randn(6, N, N),
                               dtype=dtype)
        return tuple(tsw.shallow_water_step(
            tsw.ShallowWaterState(delp, u, v), m, 300.0, 5, 0.12))
    # the damper's normalisation: SWMetrics.make's power iteration
    m2 = tsw.SWMetrics.make(CubedSphereGrid.make(N, halo=H), dtype,
                            device="cpu")
    return (torch.as_tensor(m2.divdamp_scale),)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["div_damp", "sw_step", "divdamp_scale"])
def test_dampers_and_sw_step_equal_the_full_pool_form(case, dtype, metrics,
                                                      monkeypatch):
    m = metrics[dtype]
    got = _built_on_them(case, DTYPES[dtype], m)
    use_full_pool_form(monkeypatch)
    want = _built_on_them(case, DTYPES[dtype], m)
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), (k, (g - w).abs().max())
    if case != "divdamp_scale":
        assert any(bool(g.abs().max() > 0) for g in got)
