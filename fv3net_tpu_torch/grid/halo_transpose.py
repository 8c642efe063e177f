"""Gather-form transposes of the staggered (D- and C-grid) halo exchanges.

Counterpart of the JAX package's ``grid/halo_transpose.py``.  The
divergence dampers (``dycore/sw.py`` ``div_damp``, ``corner_div_damp``)
and the damper normalisation of ``SWMetrics`` are built as M^T(W M) with
``torch.func.vjp``.  Autograd's transpose of a table gather is a
scatter-add (``index_put_`` with accumulate), which on the GPU is a sort
plus atomics.  The transpose of a halo gather is itself a gather: every
output slot reads exactly one pool entry, so grouping the slots by the
entry they read gives inverse tables, and the transpose is K gathers and
adds -- no scatter.

The inverse tables are derived mechanically from the forward tables
(``halo._staggered_gather``'s ``_dgrid_tables``/``_cgrid_tables``).  The
port's forward exchange is one gather over the whole padded lattice, in
which every pool entry is read at least by its own slot (sign +1, same
face).  Entries read by that slot alone -- the face interiors -- take
their cotangent straight from it; the entries within a few cells of a
face edge, which halo slots of the neighbours also read, form a band
whose cotangents are sums of K signed gathers.  The pool cotangent is
then one gather from [own slots | band sums].  Slots with sign 0 (the
D-grid cube corners) read nothing and contribute nothing.

``staggered_exchange`` wraps the exchange in a ``torch.autograd.Function``
whose backward is that transpose and whose jvp is the exchange itself
(it is linear), so ``torch.func.vjp`` takes the gathers and
``torch.func.jacfwd`` still works.

The shared-boundary rewrites on the same path
(``canonicalize_cgrid_boundary``, ``average_dgrid_boundary`` in
``halo.py``) keep autograd's transpose and need no table here: they
gather only the 12n or 24n boundary slots a level
(``halo._boundary_gather``) and write them into a copy, so their
backward is an ``index_fill`` of those slots and an ``index_add`` of one
partner term onto each of as many distinct entries.
A band-local transpose would not do for them: the canonicalisation routes
each shared face to its owner, and a symmetrised transpose would break
the dampers' dissipativity.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import halo as _h


def _pool_shapes(kind: str, n: int):
    """(rows_a, cols_a, rows_b, cols_b) of the stored pair."""
    if kind == "dgrid":
        return n + 1, n, n, n + 1
    return n, n + 1, n + 1, n


@lru_cache(maxsize=None)
def _inverse_tables(kind: str, n: int, h: int, fill: str):
    """Numpy inverse tables of one staggered exchange.

    Returns (direct, band_face, band_pos, band_sign, K, E):
      direct [6, P]: for each pool entry (per-face pool [a | b] of P
        entries), its index in [own H slots (Q) | band sums (E)], where H
        is the per-face concatenation of the two padded outputs;
      band_* [6, K * E]: for band entry e of face g, its k-th reader
        (H face, H position, sign) at k * E + e; unused readers sign 0.
    """
    ra, ca, rb, cb = _pool_shapes(kind, n)
    tables = (
        _h._dgrid_tables(n, h) if kind == "dgrid"
        else _h._cgrid_tables(n, h, fill)
    )
    P = ra * ca + rb * cb
    # every reader (a slot of H with a nonzero sign) of a pool entry, in
    # the order the exchange's tables list them (table, face, slot)
    dest, rf, rq, rs = [], [], [], []
    q0 = 0
    for flat, sign in tables:
        face, pos = _h._decode_pool(flat.reshape(6, -1), ra, ca, rb, cb)
        sg = np.asarray(sign).reshape(6, -1)
        for f in range(6):
            q = np.flatnonzero(sg[f])
            dest.append(face[f, q] * P + pos[f, q])
            rf.append(np.full(q.size, f))
            rq.append(q0 + q)
            rs.append(sg[f, q].astype(np.float64))
        q0 += sg.shape[1]
    Q = q0
    dest, rf, rq, rs = (np.concatenate(x) for x in (dest, rf, rq, rs))
    order = np.argsort(dest, kind="stable")  # by entry, readers in order
    dest, rf, rq, rs = dest[order], rf[order], rq[order], rs[order]
    count = np.bincount(dest, minlength=6 * P)
    start = np.cumsum(count) - count  # each entry's first reader
    k = np.arange(dest.size) - start[dest]  # each reader's rank
    g_of = np.arange(6 * P) // P
    first = np.minimum(start, max(dest.size - 1, 0))
    is_direct = (count == 1) & (rf[first] == g_of) & (rs[first] == 1.0)
    # band entries of face g, in pool order
    e_of = (np.cumsum(~is_direct.reshape(6, P), axis=1) - 1).reshape(-1)
    direct = np.where(is_direct, rq[first], Q + e_of).reshape(6, P)
    band_count = (~is_direct).reshape(6, P).sum(axis=1)
    E = int(band_count.max())
    K = int(count[~is_direct].max()) if E else 1
    band_face = np.zeros((6, K, E), np.int64)
    band_pos = np.zeros((6, K, E), np.int64)
    band_sign = np.zeros((6, K, E))
    band_face[:] = np.arange(6)[:, None, None]
    in_band = ~is_direct[dest]
    g, e = dest[in_band] // P, e_of[dest[in_band]]
    band_face[g, k[in_band], e] = rf[in_band]
    band_pos[g, k[in_band], e] = rq[in_band]
    band_sign[g, k[in_band], e] = rs[in_band]
    return (
        direct, band_face.reshape(6, -1), band_pos.reshape(6, -1),
        band_sign.reshape(6, -1), K, E,
    )


@lru_cache(maxsize=None)
def _inverse_gather(kind: str, n: int, h: int, fill: str,
                    device: torch.device, dtype: torch.dtype):
    """The inverse tables as index/sign tensors on `device`."""
    direct, bf, bp, bs, K, E = _inverse_tables(kind, n, h, fill)
    ra, ca, rb, cb = _pool_shapes(kind, n)
    sa = ra * ca

    def idx(a):
        return torch.as_tensor(a.reshape(6, 1, -1), device=device)

    return dict(
        direct_a=idx(direct[:, :sa]), direct_b=idx(direct[:, sa:]),
        band_face=idx(bf), band_pos=idx(bp),
        band_sign=torch.as_tensor(
            bs.reshape(6, 1, -1), dtype=dtype, device=device
        ),
        K=K, E=E,
    )


def staggered_transpose(ct_a, ct_b, kind: str, n: int, h: int, fill: str):
    """Adjoint of ``halo._staggered_exchange`` by gathers only: padded
    cotangents (ct_a, ct_b) -> cotangents of the stored pair."""
    ra, ca, rb, cb = _pool_shapes(kind, n)
    lead = ct_a.shape[1:-2]
    t = _inverse_gather(kind, n, h, fill, ct_a.device, ct_a.dtype)
    H = _h._pool(ct_a, ct_b)  # [6, M, Q]
    M = H.shape[1]
    band = (
        _h._gather(H, t["band_face"], t["band_pos"]) * t["band_sign"]
    ).reshape(6, M, t["K"], t["E"]).sum(2)
    ext = torch.cat([H, band], dim=-1)
    a = torch.gather(ext, -1, t["direct_a"].expand(6, M, ra * ca))
    b = torch.gather(ext, -1, t["direct_b"].expand(6, M, rb * cb))
    return (
        a.reshape((6,) + lead + (ra, ca)),
        b.reshape((6,) + lead + (rb, cb)),
    )


class _StaggeredExchange(torch.autograd.Function):
    """The staggered exchange as a linear operator: forward = the plain
    gather, backward = its gather-form transpose, jvp = the exchange of
    the tangents."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, b, kind, h, fill):
        return _h._staggered_exchange(a, b, kind, h, fill)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b, kind, h, fill = inputs
        ctx.kind, ctx.h, ctx.fill = kind, h, fill
        ctx.n = a.shape[-1] if kind == "dgrid" else a.shape[-2]

    @staticmethod
    def backward(ctx, ct_a, ct_b):
        da, db = staggered_transpose(
            ct_a, ct_b, ctx.kind, ctx.n, ctx.h, ctx.fill
        )
        return da, db, None, None, None

    @staticmethod
    def jvp(ctx, ta, tb, *_):
        return _h._staggered_exchange(ta, tb, ctx.kind, ctx.h, ctx.fill)


def staggered_exchange(a, b, kind: str, h: int, fill: str):
    """``halo._staggered_exchange`` with the gather-form transpose."""
    return _StaggeredExchange.apply(a, b, kind, h, fill)
