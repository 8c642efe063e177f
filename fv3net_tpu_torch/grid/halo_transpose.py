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
    readers = [[[] for _ in range(P)] for _ in range(6)]
    q0 = 0
    for flat, sign in tables:
        face, pos = _h._decode_pool(flat.reshape(6, -1), ra, ca, rb, cb)
        sg = np.asarray(sign).reshape(6, -1)
        for f in range(6):
            for q in np.flatnonzero(sg[f]):
                readers[face[f, q]][pos[f, q]].append(
                    (f, q0 + q, float(sg[f, q]))
                )
        q0 += sg.shape[1]
    Q = q0
    direct = np.zeros((6, P), np.int64)
    band = [[] for _ in range(6)]
    for g in range(6):
        for p in range(P):
            rd = readers[g][p]
            if len(rd) == 1 and rd[0][0] == g and rd[0][2] == 1.0:
                direct[g, p] = rd[0][1]
            else:
                direct[g, p] = Q + len(band[g])
                band[g].append(rd)
    E = max(len(b) for b in band)
    K = max((len(rd) for b in band for rd in b), default=1)
    band_face = np.zeros((6, K, E), np.int64)
    band_pos = np.zeros((6, K, E), np.int64)
    band_sign = np.zeros((6, K, E))
    for g in range(6):
        band_face[g] = g
        for e, rd in enumerate(band[g]):
            for k, (f, q, s) in enumerate(rd):
                band_face[g, k, e] = f
                band_pos[g, k, e] = q
                band_sign[g, k, e] = s
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
