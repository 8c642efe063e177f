"""Single-device halo exchange on full-cube torch tensors.

Fields live on the full cube as ``[6, ..., n, n]`` tensors; the exchange
produces padded ``[6, ..., n+2h, n+2h]`` tensors whose edge halos hold the
neighboring faces' interior values with the correct inter-face index
rotation (and component rotation for vectors).

The index tables come from the numpy table functions of the JAX package's
``grid/halo.py``, copied verbatim (they depend only on the cube
topology and geometry).  Each exchange is ONE gather over the whole padded
lattice: own positions read themselves (pass-through), halo positions read
the neighbour's stored value, times a sign for staggered vector
components.  That is bit-identical to the strip-form gathers of the JAX
package (``_halo_exchange_gather`` and friends), whose strip tables are
slices of the same full tables, with one launch per exchange instead of
one per strip.  Tables are built once per (n, h, fill) in numpy and cached
as index tensors per device.

Vector semantics: D-grid staggered winds are edge-tangential components;
across a face boundary an edge is the same physical segment, so the halo
value is the neighbor's stored value up to a sign (direction reversal) and
a u<->v swap (quarter-turn index rotation).  The index maps are derived
from the shared corner lattice, which makes the corner cases (literal cube
corners) fall out of the derivation instead of hand-coded tables.

Each single-process exchange counts its call and the bytes it writes in
``tracing.COUNTS`` (under its own name; a captured graph's replays add
its capture's counts), and no device span fires under ``spmd_mode``
(``tracing.mute_while``).

Under ``spmd_mode`` (the JAX file's lines 34-55) each public exchange
dispatches to its shard-local form over a mesh (a process group, or the
shards of one process): the face mesh's (parallel/halo_spmd.py) or, with
a TileLayout, the within-face tiled plans (parallel/tiling.py).  That is
what lets the dycore step run unchanged on one face, or one tile, per
rank or shard (parallel/spmd_dycore.py).
"""

from __future__ import annotations

import contextlib
import threading
from functools import lru_cache

import numpy as np
import torch

from .. import tracing
from . import topology as topo

class _Spmd(threading.local):
    """The active spmd_mode of this thread: the Comm of the exchange axis
    (parallel.halo_spmd.Comm or LocalComm) and its TileLayout; None: the
    single-process exchanges.  Thread-local, so that the shards of a
    local mesh (parallel.mesh.LocalMesh), one thread each, each exchange
    over their own axis."""

    axis = None
    tiling = None


_SPMD = _Spmd()


@contextlib.contextmanager
def spmd_mode(axis, tiling=None):
    """Run every exchange of this thread as its shard-local form over
    `axis`, the Comm of the mesh's face axis (or, with a TileLayout
    `tiling`, of the flattened (face, y, x) axes)."""
    prev = (_SPMD.axis, _SPMD.tiling)
    _SPMD.axis, _SPMD.tiling = axis, tiling
    try:
        yield
    finally:
        _SPMD.axis, _SPMD.tiling = prev


def spmd_axis():
    """The Comm of this thread's spmd_mode (None outside one)."""
    return _SPMD.axis


def spmd_active() -> bool:
    """Whether this thread's exchanges run over a mesh (spmd_mode)."""
    return _SPMD.axis is not None


# a mesh's shards interleave on several streams: no device span there
tracing.mute_while(spmd_active)


# ---------------------------------------------------------------------------
# numpy table functions (verbatim from the JAX package's grid/halo.py)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _scalar_tables(n: int, h: int, fill: str = "none"):
    if fill == "none":
        src_face, src_j, src_i, corner_mask = topo.halo_source_indices(n, h)
    else:
        src_face, src_j, src_i, corner_mask = (
            topo.halo_source_indices_filled(n, h, fill)
        )
    flat = (src_face * n + src_j) * n + src_i
    return flat, corner_mask


@lru_cache(maxsize=None)
def _agrid_vector_tables(n: int, h: int):
    """Rotation coefficient tables for A-grid vector halo exchange."""
    np_sz = n + 2 * h
    m00 = np.ones((6, np_sz, np_sz))
    m01 = np.zeros((6, np_sz, np_sz))
    m10 = np.zeros((6, np_sz, np_sz))
    m11 = np.ones((6, np_sz, np_sz))
    for f in range(6):
        for e in range(4):
            l = topo.link(f, e)
            r = l.rot
            c, s = [(1, 0), (0, 1), (-1, 0), (0, -1)][r]
            # M = [[c, -s], [s, c]] maps neighbor (u,v) -> ours
            if e == topo.EDGE_W:
                sl = np.s_[f, h : h + n, 0:h]
            elif e == topo.EDGE_E:
                sl = np.s_[f, h : h + n, h + n :]
            elif e == topo.EDGE_S:
                sl = np.s_[f, 0:h, h : h + n]
            else:
                sl = np.s_[f, h + n :, h : h + n]
            m00[sl], m01[sl], m10[sl], m11[sl] = c, -s, s, c
    return m00, m01, m10, m11


def _quantize(xyz: np.ndarray) -> np.ndarray:
    """Quantize unit-sphere coords to integers for exact matching."""
    return np.round(xyz * 1e9).astype(np.int64)



def _edge_keys(A, B):
    """Quantized corner pairs [..., 3] -> (key [..., 6] with the two
    corners in lexicographic order, the quantized first corner)."""
    qa, qb = _quantize(A), _quantize(B)
    # qa <= qb as tuples: decided by the first component that differs
    diff = qa != qb
    first = np.argmax(diff, axis=-1)[..., None]
    a_first = ~diff.any(-1) | (np.take_along_axis(qa, first, -1)[..., 0]
                               < np.take_along_axis(qb, first, -1)[..., 0])
    lo = np.where(a_first[..., None], qa, qb)
    hi = np.where(a_first[..., None], qb, qa)
    return np.concatenate([lo, hi], axis=-1), qa


def _as_void(keys):
    """[M, 6] int64 rows as one comparable value each."""
    keys = np.ascontiguousarray(keys)
    return keys.view(np.dtype((np.void, keys.dtype.itemsize * 6)))[:, 0]


@lru_cache(maxsize=None)
def _dgrid_tables(n: int, h: int):
    """Gather tables for D-grid staggered wind halo exchange.

    u[J, i] lives on the x-directed edge between corners (J, i), (J, i+1):
    shape (n+1, n).  v[j, I] on the y-directed edge between corners (j, I),
    (j+1, I): shape (n, n+1).  Across a face boundary an edge is the same
    physical great-circle segment, so we match halo edge positions to
    stored edges geometrically: each edge is keyed by the quantized xyz of
    its (unordered) corner pair; the sign is +1 when the stored direction
    agrees with the query direction.  This derivation makes every corner
    case (including edges straddling the face boundary and the literal
    cube corners) fall out automatically.  (The JAX package builds the
    same tables with a Python loop over every edge; here the lookup is
    vectorised: the same keys, the same first-writer-wins order, the
    same tables, tests/test_torch_grid.py.)
    """
    from .geometry import extended_corners, gnomonic_grid

    base = gnomonic_grid(n)  # [6, n+1, n+1, 3]
    ext = extended_corners(n, h)  # [6, n+2h+1, n+2h+1, 3] (NaN corners)
    nu = (n + 1) * n  # one face's u count; v entries offset by 6*nu

    # every stored edge, in the order the faces store them (face by face,
    # its u edges then its v edges): shared-boundary edges are stored by
    # two faces, and the first writer wins (values are consistent by
    # construction)
    keys, froms, flats = [], [], []
    for g in range(6):
        for kind in ("u", "v"):
            if kind == "u":
                A, B = base[g, :, :-1], base[g, :, 1:]
                flat = (g * (n + 1) + np.arange(n + 1)[:, None]) * n \
                    + np.arange(n)[None, :]
            else:
                A, B = base[g, :-1, :], base[g, 1:, :]
                flat = 6 * nu + (g * n + np.arange(n)[:, None]) * (n + 1) \
                    + np.arange(n + 1)[None, :]
            k, qa = _edge_keys(A, B)
            keys.append(k.reshape(-1, 6))
            froms.append(qa.reshape(-1, 3))
            flats.append(flat.reshape(-1))
    keys, froms, flats = (np.concatenate(x) for x in (keys, froms, flats))
    table, first = np.unique(_as_void(keys), return_index=True)
    froms, flats = froms[first], flats[first]

    def build(kind: str):
        if kind == "u":
            shp = (6, n + 2 * h + 1, n + 2 * h)
            A, B = ext[:, :, :-1], ext[:, :, 1:]
        else:
            shp = (6, n + 2 * h, n + 2 * h + 1)
            A, B = ext[:, :-1, :], ext[:, 1:, :]
        f, a, b = np.meshgrid(*(np.arange(m) for m in shp), indexing="ij")
        # own lattice positions (interior AND own boundary) pass through
        # identically -- the exchange must never overwrite a face's own
        # stored edge values.
        if kind == "u":
            own = (h <= a) & (a <= h + n) & (h <= b) & (b < h + n)
            own_flat = (f * (n + 1) + (a - h)) * n + (b - h)
        else:
            own = (h <= a) & (a < h + n) & (h <= b) & (b <= h + n)
            own_flat = 6 * nu + (f * n + (a - h)) * (n + 1) + (b - h)
        flat = np.zeros(shp, dtype=np.int64)
        sign = np.zeros(shp, dtype=np.float64)
        flat[own] = own_flat[own]
        sign[own] = 1.0
        query = ~own & np.isfinite(A).all(-1) & np.isfinite(B).all(-1)
        k, qa = _edge_keys(A[query], B[query])
        k = _as_void(k)
        pos = np.minimum(np.searchsorted(table, k), table.size - 1)
        hit = table[pos] == k
        idx = np.flatnonzero(query)[hit]
        flat.reshape(-1)[idx] = flats[pos[hit]]
        same = (froms[pos[hit]] == qa[hit]).all(-1)
        sign.reshape(-1)[idx] = np.where(same, 1.0, -1.0)
        return flat, sign

    return build("u"), build("v")


def _rot_matrix(rot: int) -> np.ndarray:
    c, s = [(1, 0), (0, 1), (-1, 0), (0, -1)][rot]
    return np.array([[c, -s], [s, c]])



@lru_cache(maxsize=None)
def _cgrid_tables(n: int, h: int, fill: str):
    """Gather tables for C-grid (face-normal) staggered fields.

    uc [6, n, n+1]: x-component stored on x-faces (between cells (j,i-1)
    and (j,i), face index i); vc [6, n+1, n]: y-component on y-faces.
    Used for C-grid winds, Courant numbers and mass fluxes.

    Slots are resolved through the neighbor charts via the affine edge
    maps; the component sign/swap comes from the chart rotation matrix.
    Cube-corner slots are resolved by chart composition, ordered so the
    value equals bit-for-bit what the strip-owning neighbor holds in its
    own (single-map) halo -- the property that makes shared-edge fluxes
    cancel exactly and keeps global mass conservation to roundoff.
    fill='x' orders the composition for fields consumed by x-direction
    stencils (first through the y-neighbor), 'y' the transpose.
    """
    assert fill in ("x", "y")
    first = "y" if fill == "x" else "x"
    N = n + 2 * h
    nu = n * (n + 1)  # own uc size per face; vc offset = 6*nu

    def uc_flat(g, j, i_face):
        return (g * n + j) * (n + 1) + i_face

    def vc_flat(g, j_face, i):
        return 6 * nu + (g * (n + 1) + j_face) * n + i

    def resolve(f, c1, c2):
        """Map adjacent cell pair (possibly out of face) to the stored
        face value: returns (flat, sign_x, sign_y) where sign_x/sign_y
        are the coefficients for an x-normal / y-normal query slot."""
        from .topology import _edge_map_affine, link, EDGE_W, EDGE_E, \
            EDGE_S, EDGE_N

        def extract(g, cells, M):
            """Return the stored-value triple if the pair is a stored
            face of face g (boundary faces included), else None.

            value_f = M @ (u, v)_g (M maps neighbor components to
            ours); only the mapped face's normal component is stored,
            so the coefficient is the corresponding M entry.
            """
            (j1, i1), (j2, i2) = cells[0], cells[1]
            if j1 == j2 and abs(i1 - i2) == 1:
                if 0 <= j1 < n and 0 <= max(i1, i2) <= n:
                    return (
                        uc_flat(g, int(j1), int(max(i1, i2))),
                        M[0, 0],
                        M[1, 0],
                    )
            if i1 == i2 and abs(j1 - j2) == 1:
                if 0 <= i1 < n and 0 <= max(j1, j2) <= n:
                    return (
                        vc_flat(g, int(max(j1, j2)), int(i1)),
                        M[0, 1],
                        M[1, 1],
                    )
            return None

        M = np.eye(2, dtype=int)
        g = f
        cells = [np.array(c1), np.array(c2)]
        for _ in range(3):
            got = extract(g, cells, M)
            if got is not None:
                return got
            out_j = [not (0 <= c[0] < n) for c in cells]
            out_i = [not (0 <= c[1] < n) for c in cells]
            # a chart change is only valid along a coordinate that is
            # out of range for BOTH cells; when both coordinates qualify
            # (genuine corner), use the fill preference
            j_both = out_j[0] and out_j[1]
            i_both = out_i[0] and out_i[1]
            if j_both and i_both:
                use_y = first == "y"
            elif j_both:
                use_y = True
            elif i_both:
                use_y = False
            else:
                raise RuntimeError("straddling pair cannot be resolved")
            ref = cells[0] if (out_j[0] if use_y else out_i[0]) else cells[1]
            if use_y:
                e = EDGE_S if ref[0] < 0 else EDGE_N
            else:
                e = EDGE_W if ref[1] < 0 else EDGE_E
            l = link(g, e)
            A, b = _edge_map_affine(l, n)
            cells = [A @ c + b for c in cells]
            M = _rot_matrix(l.rot) @ M
            g = l.nbr_face
        raise RuntimeError(f"cgrid resolve failed: {cells}")

    def build(kind):
        if kind == "uc":
            shp = (6, N, N + 1)
        else:
            shp = (6, N + 1, N)
        flat = np.zeros(shp, dtype=np.int64)
        sign = np.zeros(shp, dtype=np.float64)
        for f in range(6):
            for a in range(shp[1]):
                for b_ in range(shp[2]):
                    if kind == "uc":
                        # x-face at padded (row a, face col b_): cells
                        # (a-h, b_-h-1) and (a-h, b_-h)
                        j = a - h
                        c1 = (j, b_ - h - 1)
                        c2 = (j, b_ - h)
                        own = 0 <= j < n and h <= b_ <= h + n
                        if own:
                            flat[f, a, b_] = uc_flat(f, j, b_ - h)
                            sign[f, a, b_] = 1.0
                            continue
                    else:
                        i = b_ - h
                        c1 = (a - h - 1, i)
                        c2 = (a - h, i)
                        own = 0 <= i < n and h <= a <= h + n
                        if own:
                            flat[f, a, b_] = vc_flat(f, a - h, i)
                            sign[f, a, b_] = 1.0
                            continue
                    # skip slots whose cells cannot be resolved (beyond
                    # the diagonal reach of two charts)
                    try:
                        fl, sx, sy = resolve(f, c1, c2)
                    except (RuntimeError, ValueError, KeyError):
                        continue
                    s = sx if kind == "uc" else sy
                    if s == 0:
                        continue
                    flat[f, a, b_] = fl
                    sign[f, a, b_] = float(s)
        return flat, sign

    return build("uc"), build("vc")



@lru_cache(maxsize=None)
def _cgrid_boundary_canon_tables(n: int):
    """Canonicalization tables for the two stored copies of shared
    boundary C-faces.

    Each face stores its own value for every one of its boundary faces
    (uc columns 0 and n, vc rows 0 and n), so every physical
    tile-boundary face has TWO stored copies.  When the two owners
    compute different values (the reconstructions see different halo
    inputs at corner-adjacent cells), shared-face mass fluxes no longer
    cancel and global conservation breaks for non-symmetric flows.
    These tables let the higher-indexed face adopt the lower-indexed
    face's copy (sign-rotated into its own frame): for every boundary
    slot of every face, (neighbor_pool_index, coefficient,
    replace_mask).  The FMS-equivalent convention is mpp's domain
    symmetry on staggered fields.
    """
    from .topology import (
        _edge_map_affine,
        link,
        EDGE_W,
        EDGE_E,
        EDGE_S,
        EDGE_N,
    )

    nu = n * (n + 1)

    def uc_flat(g, j, i_face):
        return (g * n + j) * (n + 1) + i_face

    def vc_flat(g, j_face, i):
        return 6 * nu + (g * (n + 1) + j_face) * n + i

    def neighbor_copy(f, edge, cells):
        """(pool_flat, coef) of the neighbor's stored copy for the
        boundary face between `cells` = ((j1,i1),(j2,i2)) of face f."""
        l = link(f, edge)
        A, b = _edge_map_affine(l, n)
        M = _rot_matrix(l.rot)
        g = l.nbr_face
        (j1, i1), (j2, i2) = [A @ np.array(c) + b for c in cells]
        if j1 == j2 and abs(i1 - i2) == 1:
            return uc_flat(g, int(j1), int(max(i1, i2))), M[0, 0], M[1, 0]
        if i1 == i2 and abs(j1 - j2) == 1:
            return vc_flat(g, int(max(j1, j2)), int(i1)), M[0, 1], M[1, 1]
        raise RuntimeError("boundary pair did not map to a stored face")

    # output tables over the stored arrays' own shapes
    uc_idx = np.zeros((6, n, n + 1), np.int64)
    uc_coef = np.zeros((6, n, n + 1))
    uc_rep = np.zeros((6, n, n + 1), bool)
    vc_idx = np.zeros((6, n + 1, n), np.int64)
    vc_coef = np.zeros((6, n + 1, n))
    vc_rep = np.zeros((6, n + 1, n), bool)
    for f in range(6):
        for edge, col in ((EDGE_W, 0), (EDGE_E, n)):
            l = link(f, edge)
            if l.nbr_face >= f:
                continue
            for j in range(n):
                cells = ((j, col - 1), (j, col))
                fl, cx, _ = neighbor_copy(f, edge, cells)
                uc_idx[f, j, col] = fl
                uc_coef[f, j, col] = cx
                uc_rep[f, j, col] = True
        for edge, row in ((EDGE_S, 0), (EDGE_N, n)):
            l = link(f, edge)
            if l.nbr_face >= f:
                continue
            for i in range(n):
                cells = ((row - 1, i), (row, i))
                fl, _, cy = neighbor_copy(f, edge, cells)
                vc_idx[f, row, i] = fl
                vc_coef[f, row, i] = cy
                vc_rep[f, row, i] = True
    return (
        uc_idx.astype(np.int32), uc_coef, uc_rep,
        vc_idx.astype(np.int32), vc_coef, vc_rep,
    )



@lru_cache(maxsize=None)
def _dgrid_boundary_pair_tables(n: int):
    """For every boundary D-edge of every face, the (pool_flat, sign)
    of the OTHER face's stored copy of the same physical edge.

    The D-grid state [6, n+1, n]/[6, n, n+1] stores each shared
    boundary edge TWICE (once per adjacent face); the two copies are
    updated independently by each face's stencils and drift apart at
    the inter-face coordinate kink.  These tables support averaging
    the copies (mpp domain-symmetry role).  Cube-corner-touching edges
    are included; entries with pair_mask False have no partner (none,
    for the closed cube).
    """
    from .geometry import gnomonic_grid

    base = gnomonic_grid(n)  # [6, n+1, n+1, 3]
    nu = (n + 1) * n

    table: dict = {}

    def key_of(A, B):
        ka, kb = tuple(_quantize(A)), tuple(_quantize(B))
        return ((ka, kb) if ka <= kb else (kb, ka)), ka

    def store(kind, g, a, b, A, B):
        key, ka = key_of(A, B)
        flat = (
            (g * (n + 1) + a) * n + b
            if kind == "u"
            else 6 * nu + (g * n + a) * (n + 1) + b
        )
        table.setdefault(key, []).append((flat, ka))

    for g in range(6):
        for J in (0, n):
            for i in range(n):
                store("u", g, J, i, base[g, J, i], base[g, J, i + 1])
        for j in range(n):
            for I in (0, n):
                store("v", g, j, I, base[g, j, I], base[g, j + 1, I])

    u_idx = np.zeros((6, n + 1, n), np.int64)
    u_sign = np.zeros((6, n + 1, n))
    u_mask = np.zeros((6, n + 1, n), bool)
    v_idx = np.zeros((6, n, n + 1), np.int64)
    v_sign = np.zeros((6, n, n + 1))
    v_mask = np.zeros((6, n, n + 1), bool)

    def fill(kind, g, a, b, A, B):
        key, ka = key_of(A, B)
        entries = table.get(key, [])
        flat_self = (
            (g * (n + 1) + a) * n + b
            if kind == "u"
            else 6 * nu + (g * n + a) * (n + 1) + b
        )
        others = [e for e in entries if e[0] != flat_self]
        if not others:
            return
        flat, stored_from = others[0]
        sgn = 1.0 if stored_from == ka else -1.0
        if kind == "u":
            u_idx[g, a, b] = flat
            u_sign[g, a, b] = sgn
            u_mask[g, a, b] = True
        else:
            v_idx[g, a, b] = flat
            v_sign[g, a, b] = sgn
            v_mask[g, a, b] = True

    for g in range(6):
        for J in (0, n):
            for i in range(n):
                fill("u", g, J, i, base[g, J, i], base[g, J, i + 1])
        for j in range(n):
            for I in (0, n):
                fill("v", g, j, I, base[g, j, I], base[g, j + 1, I])
    return (
        u_idx.astype(np.int32), u_sign, u_mask,
        v_idx.astype(np.int32), v_sign, v_mask,
    )



# ---------------------------------------------------------------------------
# table decoding into per-device gather indices
# ---------------------------------------------------------------------------


def _decode_pool(flat, rows_a, cols_a, rows_b, cols_b):
    """Split flat indices of the two-segment pool [a (6 faces); b (6
    faces)] into (face, position) over the per-face concatenation
    [a_f | b_f] of length rows_a*cols_a + rows_b*cols_b."""
    flat = np.asarray(flat, np.int64)
    sa = rows_a * cols_a
    sb = rows_b * cols_b
    in_a = flat < 6 * sa
    fb = flat - 6 * sa
    face = np.where(in_a, flat // sa, fb // sb)
    pos = np.where(in_a, flat % sa, sa + fb % sb)
    return face, pos


def _index_tensors(face, pos, device):
    """[6, P] numpy (face, pos) -> broadcastable [6, 1, P] int64 tensors."""
    def t(a):
        return torch.as_tensor(
            np.asarray(a, np.int64).reshape(6, 1, -1), device=device
        )

    return t(face), t(pos)


@lru_cache(maxsize=None)
def _scalar_gather(n: int, h: int, fill: str, device: torch.device):
    flat, _ = _scalar_tables(n, h, fill)
    return _index_tensors(flat // (n * n), flat % (n * n), device)


@lru_cache(maxsize=None)
def scalar_gather_flat(n: int, h: int, nz: int, fill: str,
                       device: torch.device):
    """The gather table of ``halo_exchange(q, h, fill)`` for q [6, nz, n, n]
    as int32 flat positions [6, N*N] (N = n + 2h) into q at level 0: slot
    (f, p) of the padded level k is q.reshape(-1)[table[f, p] + k * n * n],
    i.e. table[f, p] = (face' * nz) * n * n + pos' for the source cell
    (face', pos').  A kernel reads the exchanged field through it without
    the exchanged copy being written."""
    if 6 * nz * n * n >= 2 ** 31:
        raise ValueError(f"[6, {nz}, {n}, {n}] does not fit int32 indices")
    flat, _ = _scalar_tables(n, h, fill)
    flat = np.asarray(flat, np.int64).reshape(6, -1)
    face, pos = flat // (n * n), flat % (n * n)
    return torch.as_tensor((face * nz * n * n + pos).astype(np.int32),
                           device=device)


@lru_cache(maxsize=None)
def cgrid_canon_gather_flat(n: int, h: int, device: torch.device):
    """The tables of ``canonicalize_cgrid_boundary`` followed by
    ``halo_exchange_cgrid``, composed, for the four padded lattices of
    the C half-stage: uc fill x cropped to [N, N], vc fill y cropped to
    [N, N], vc fill x and uc fill y (N = n + 2h).

    Returns (src int32, coef float32), each [4, 6, N, N]: slot (o, f, J,
    I) of lattice o holds coef times the stored own value of C face
    src = ((kind * 6 + g) * N + J') * N + I', an x-face (kind 0: uc of
    face g at padded (J', I'), J' in [h, h+n), I' in [h, h+n]) or a
    y-face (kind 1: vc, J' in [h, h+n], I' in [h, h+n)).  The coefficient
    is the exchange's sign times the canonicalisation's (each +-1 or 0),
    so the product equals the two chained products bit for bit.  A
    kernel computes each slot's own face where it needs it, and no
    exchanged copy is written."""
    N, nu = n + 2 * h, n * (n + 1)
    ia, ca, ma, ib, cb, mb = _cgrid_boundary_canon_tables(n)
    # the canonical pool: slot P of the stored pair [uc (6 faces); vc (6
    # faces)] holds canon_coef[P] * own[canon_src[P]]
    canon_src = np.arange(12 * nu, dtype=np.int64)
    canon_coef = np.ones(12 * nu)
    for part, idx, coef, rep in ((0, ia, ca, ma), (1, ib, cb, mb)):
        rep = np.asarray(rep).reshape(-1)
        sl = slice(part * 6 * nu, (part + 1) * 6 * nu)
        canon_src[sl][rep] = np.asarray(idx).reshape(-1)[rep]
        canon_coef[sl][rep] = np.asarray(coef).reshape(-1)[rep]

    def padded_code(p):
        """Pool index -> the own face's padded code."""
        kind = (p >= 6 * nu).astype(np.int64)
        q = p - kind * 6 * nu
        g, r = q // nu, q % nu
        row_len = np.where(kind == 0, n + 1, n)
        J, I = r // row_len + h, r % row_len + h
        return ((kind * 6 + g) * N + J) * N + I

    src, coef = [], []
    tables = {fill: _cgrid_tables(n, h, fill) for fill in ("x", "y")}
    for fill, which in (("x", 0), ("y", 1), ("x", 1), ("y", 0)):
        flat, sign = tables[fill][which]
        crop = np.s_[:, :, :N] if which == 0 else np.s_[:, :N, :]
        flat, sign = np.asarray(flat)[crop], np.asarray(sign)[crop]
        src.append(padded_code(canon_src[flat]))
        coef.append(sign * canon_coef[flat])
    src = np.stack(src)
    if src.max() >= 2 ** 31:
        raise ValueError(f"C{n} with halo {h} does not fit int32 codes")
    return (torch.as_tensor(src.astype(np.int32), device=device),
            torch.as_tensor(np.stack(coef).astype(np.float32),
                            device=device))


@lru_cache(maxsize=None)
def _staggered_gather(kind: str, n: int, h: int, fill: str,
                      device: torch.device, dtype: torch.dtype):
    """(face, pos, sign) gather tensors for both outputs of a D- or
    C-grid pair exchange."""
    if kind == "dgrid":
        tables = _dgrid_tables(n, h)
        shape = (n + 1, n, n, n + 1)
    else:
        tables = _cgrid_tables(n, h, fill)
        shape = (n, n + 1, n + 1, n)
    out = []
    for flat, sign in tables:
        face, pos = _decode_pool(flat.reshape(6, -1), *shape)
        fi, pi = _index_tensors(face, pos, device)
        sg = torch.as_tensor(
            np.asarray(sign).reshape(6, 1, -1), dtype=dtype, device=device
        )
        out.append((fi, pi, sg, flat.shape[1:]))
    return tuple(out)


@lru_cache(maxsize=None)
def _boundary_gather(kind: str, n: int, nz: int, device: torch.device,
                     dtype: torch.dtype):
    """Compact tables of the shared-boundary slots (canonicalisation of
    C-faces, averaging of D-edges) of a stored pair a [6, nz, ra, ca],
    b [6, nz, rb, cb], both flattened.

    For each of a and b: (slot, from_a, from_b, coef), over its replaced
    (canon) or paired (avg) slots at every level, those whose partner
    lies in a first: `slot` the slots' flat positions in the array
    itself, `from_a` / `from_b` their partners' flat positions in a /
    in b, `coef` each slot's coefficient or sign.  12n (canon) or 24n
    (avg) slots a level in all, and no two of them share a partner, so
    the transpose of the gather scatters distinct entries."""
    if kind == "canon":
        ia, ca, ma, ib, cb, mb = _cgrid_boundary_canon_tables(n)
        shape = (n, n + 1, n + 1, n)
    else:
        ia, ca, ma, ib, cb, mb = _dgrid_boundary_pair_tables(n)
        shape = (n + 1, n, n, n + 1)
    sa, sb = shape[0] * shape[1], shape[2] * shape[3]
    level = np.arange(nz)

    def flat(face, pos, size):
        """[S] (face, pos) -> [S * nz] flat positions in [6, nz, size]."""
        return ((face[:, None] * nz + level) * size + pos[:, None]).ravel()

    def t(a, dt=torch.int64):
        return torch.as_tensor(a, dtype=dt, device=device)

    out = []
    for idx, coef, mask, size in ((ia, ca, ma, sa), (ib, cb, mb, sb)):
        face, pos = np.nonzero(np.asarray(mask).reshape(6, -1))
        g, q = _decode_pool(np.asarray(idx).reshape(6, -1)[face, pos],
                            *shape)
        cf = np.asarray(coef).reshape(6, -1)[face, pos]
        in_a = q < sa
        order = np.concatenate([np.flatnonzero(in_a),
                                np.flatnonzero(~in_a)])
        out.append((
            t(flat(face[order], pos[order], size)),
            t(flat(g[in_a], q[in_a], sa)),
            t(flat(g[~in_a], q[~in_a] - sa, sb)),
            t(np.repeat(cf[order], nz), dtype),
        ))
    return tuple(out)


# ---------------------------------------------------------------------------
# the exchanges
# ---------------------------------------------------------------------------


def _gather(src, fi, pi):
    """out[f, m, p] = src[fi[f, p], m, pi[f, p]] for src [6, M, S]."""
    m = torch.arange(src.shape[1], device=src.device).view(1, -1, 1)
    return src[fi, m, pi]


def _pool(a, b):
    """Per-face concatenation [6, M, A + B] of two staggered arrays."""
    return torch.cat(
        [a.reshape(6, -1, a.shape[-2] * a.shape[-1]),
         b.reshape(6, -1, b.shape[-2] * b.shape[-1])], dim=-1,
    )


def halo_exchange(field, h: int, fill: str = "none"):
    """Pad a cell-centered scalar [6, ..., n, n] with h halo cells.

    fill='none': cube-corner halo slots get the nearest edge value
    (clipped index) and must not be consumed by stencils.
    fill='x' / 'y': corner slots are resolved to the true third-face
    cells by row / column continuation -- the cube-topology-exact
    version of FV3's copy_corners(dir=1/2) (tp_core.F90); use 'y' before
    y-direction stencils that run on x-halo columns and vice versa.
    """
    if _SPMD.tiling is not None:
        from ..parallel import tiling as _tl

        return _tl.halo_exchange_tiled(field, _SPMD.tiling, fill, _SPMD.axis)
    if _SPMD.axis is not None:
        from ..parallel import halo_spmd as _hs

        return _hs.halo_exchange_local(field, h, fill, _SPMD.axis)
    n = field.shape[-1]
    N = n + 2 * h
    fi, pi = _scalar_gather(n, h, fill, field.device)
    out = _gather(field.reshape(6, -1, n * n), fi, pi)
    tracing.exchanged("halo_exchange", out)
    return out.reshape(field.shape[:-2] + (N, N))


def halo_exchange_vector_cgrid(u, v, h: int):
    """Halo-exchange an A-grid (cell-centered) vector with rotation.

    u, v: [6, ..., n, n] components along the face-local x / y directions.
    Returns padded (u, v) with halo components rotated into this face's
    frame (the rotation tables staged to the fields' device once).
    """
    n = u.shape[-1]
    up = halo_exchange(u, h)
    vp = halo_exchange(v, h)
    m00, m01, m10, m11 = _agrid_vector_tensors(n, h, u.dtype, u.device)
    uo = m00 * up + m01 * vp
    vo = m10 * up + m11 * vp
    return uo, vo


@lru_cache(maxsize=None)
def _agrid_vector_tensors(n: int, h: int, dtype: torch.dtype,
                          device: torch.device):
    """The rotation tables of halo_exchange_vector_cgrid on `device`."""
    return tuple(
        torch.as_tensor(a, dtype=dtype, device=device)
        for a in _agrid_vector_tables(n, h)
    )


def _staggered_exchange(a, b, kind, h, fill):
    """The plain staggered exchange (one signed gather per output).  Its
    autograd transpose is a scatter-add; the public exchanges route
    through halo_transpose.staggered_exchange, whose transpose is
    gathers."""
    n = a.shape[-1] if kind == "dgrid" else a.shape[-2]
    pool = _pool(a, b)
    outs = []
    for fi, pi, sg, shp in _staggered_gather(
        kind, n, h, fill, a.device, a.dtype
    ):
        outs.append(
            (_gather(pool, fi, pi) * sg).reshape(a.shape[:-2] + shp)
        )
    return outs[0], outs[1]


def halo_exchange_dgrid(u, v, h: int):
    """Halo-exchange D-grid staggered winds.

    u: [6, ..., n+1, n] x-edge tangential component
    v: [6, ..., n, n+1] y-edge tangential component
    Returns padded (u [6,...,n+2h+1,n+2h], v [6,...,n+2h,n+2h+1]); the halo
    holds the neighbor's u or v value on the same physical edge with the
    correct sign.  Positions with no well-defined source (cube corners)
    are zero.  Reverse-mode autodiff transposes it by gathers
    (halo_transpose.py), not by a scatter-add.
    """
    if _SPMD.tiling is not None:
        from ..parallel import tiling as _tl

        return _tl.halo_exchange_dgrid_tiled(u, v, _SPMD.tiling, _SPMD.axis)
    if _SPMD.axis is not None:
        from ..parallel import halo_spmd as _hs

        return _hs.halo_exchange_dgrid_local(u, v, h, _SPMD.axis)
    from .halo_transpose import staggered_exchange

    out = staggered_exchange(u, v, "dgrid", h, "")
    tracing.exchanged("halo_exchange_dgrid", *out)
    return out


def halo_exchange_cgrid(uc, vc, h: int, fill: str = "y"):
    """Halo-exchange C-grid (face-normal) components with corner fill.

    uc: [6, ..., n, n+1] x-component at x-faces; vc: [6, ..., n+1, n].
    Returns padded (uc [6,...,N,N+1], vc [6,...,N+1,N]), N = n+2h, with
    halo AND cube-corner slots holding the neighbors' stored values
    rotated into this face's frame (see _cgrid_tables).  Transposed by
    gathers, as halo_exchange_dgrid.
    """
    if _SPMD.tiling is not None:
        from ..parallel import tiling as _tl

        return _tl.halo_exchange_cgrid_tiled(
            uc, vc, _SPMD.tiling, fill, _SPMD.axis
        )
    if _SPMD.axis is not None:
        from ..parallel import halo_spmd as _hs

        return _hs.halo_exchange_cgrid_local(uc, vc, h, fill, _SPMD.axis)
    from .halo_transpose import staggered_exchange

    out = staggered_exchange(uc, vc, "cgrid", h, fill)
    tracing.exchanged("halo_exchange_cgrid", *out)
    return out


def _boundary_partner(a, b, kind):
    """The stored pair with its shared-boundary slots rewritten, as flat
    fresh copies of a and b: a replaced slot takes partner * coef
    (canon), a paired slot 0.5 * (own + partner * sign) (avg); every
    other slot keeps its own value.  Only the 12n or 24n boundary slots
    a level are gathered (``_boundary_gather``), so autograd's transpose
    scatters one partner term onto each of as many distinct entries."""
    n = a.shape[-1] if kind == "avg" else a.shape[-2]
    nz = a[0].numel() // (a.shape[-2] * a.shape[-1])
    af, bf = a.reshape(-1), b.reshape(-1)
    outs = []
    for own, (slot, from_a, from_b, cf) in zip(
        (af, bf), _boundary_gather(kind, n, nz, a.device, a.dtype)
    ):
        p = torch.cat([af.index_select(0, from_a),
                       bf.index_select(0, from_b)]) * cf
        if kind == "avg":
            p = 0.5 * (own.index_select(0, slot) + p)
        outs.append(own.index_copy(0, slot, p))
    return outs


def canonicalize_cgrid_boundary(uc, vc):
    """Make the two stored copies of every shared boundary C-face equal:
    the higher-indexed face adopts the lower-indexed face's value
    (rotated into its frame).  Restores exact shared-face flux
    cancellation (global mass conservation to roundoff) for arbitrary
    wind fields.  uc: [6, ..., n, n+1]; vc: [6, ..., n+1, n]."""
    if _SPMD.tiling is not None:
        from ..parallel import tiling as _tl

        return _tl.canonicalize_cgrid_boundary_tiled(
            uc, vc, _SPMD.tiling, _SPMD.axis
        )
    if _SPMD.axis is not None:
        from ..parallel import halo_spmd as _hs

        return _hs.canonicalize_cgrid_boundary_local(uc, vc, _SPMD.axis)
    uo, vo = _boundary_partner(uc, vc, "canon")
    tracing.exchanged("canonicalize_cgrid_boundary", uo, vo)
    return uo.view(uc.shape), vo.view(vc.shape)


def average_dgrid_boundary(u, v):
    """Replace both stored copies of every shared boundary D-edge with
    their (sign-consistent) average.  u: [6, ..., n+1, n],
    v: [6, ..., n, n+1]; the interior is untouched."""
    if _SPMD.tiling is not None:
        from ..parallel import tiling as _tl

        return _tl.average_dgrid_boundary_tiled(u, v, _SPMD.tiling,
                                                _SPMD.axis)
    if _SPMD.axis is not None:
        from ..parallel import halo_spmd as _hs

        return _hs.average_dgrid_boundary_local(u, v, _SPMD.axis)
    uo, vo = _boundary_partner(u, v, "avg")
    tracing.exchanged("average_dgrid_boundary", uo, vo)
    return uo.view(u.shape), vo.view(v.shape)


def extend_cells_one(field):
    """Pad a cell-centered field [6 (or L), ..., n, n] by ONE ghost cell
    per side within the face: edge replication at face level (and at
    true face boundaries under tiling), neighbour-tile cells at
    within-face tile boundaries.  Bit-preserving contract: one-sided
    boundary formulas written as 0.5*(ext[j] + ext[j+1]) reproduce their
    pre-extension bits (0.5*(x+x) == x)."""
    if _SPMD.tiling is not None:
        from ..parallel import tiling as _tl

        return _tl.extend_cells_one_tiled(field, _SPMD.tiling, _SPMD.axis)
    return edge_pad(field, 1)


def edge_pad(x, w: int):
    """Edge-replicating pad of the last two axes by w on every side
    (jnp.pad mode='edge')."""
    Y, X = x.shape[-2], x.shape[-1]
    rj = torch.arange(-w, Y + w, device=x.device).clamp(0, Y - 1)
    ri = torch.arange(-w, X + w, device=x.device).clamp(0, X - 1)
    return x.index_select(-2, rj).index_select(-1, ri)
