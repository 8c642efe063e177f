"""Cubed-sphere face topology.

The six faces of the FV3 cubed sphere, their edge adjacency, the index
correspondence across shared edges, and the signed permutation applied to
vector components when they cross a face boundary.

Everything here is *static* (numpy at setup time): the outputs are integer
index tables that the halo-exchange gathers read (built once per face
size and cached).

The face arrangement reproduces the FV3 mosaic encoded (as data) by the
reference's ``external/vcm/vcm/cubedsphere/xgcm.py:6-35``
(``FV3_FACE_CONNECTIONS``): faces 0,1 are equatorial "upright" faces, face 2
is the north-polar cap, faces 3,4 are equatorial rotated faces and face 5 is
the south-polar cap (0-based).  Rather than hard-coding the twelve edge
links, we embed each face in R^3 with an explicit orthonormal frame and
*derive* adjacency + index alignment geometrically, then verify against the
known contact list in tests.

Index conventions
-----------------
Fields are laid out ``[face, ..., j, i]`` where ``i`` (last axis, contiguous)
increases along the face-local ``ex`` direction and ``j`` along ``ey``.
Edges are W (i lower), E (i upper), S (j lower), N (j upper).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Tuple

import numpy as np

EDGE_W, EDGE_E, EDGE_S, EDGE_N = 0, 1, 2, 3
EDGE_NAMES = ("W", "E", "S", "N")

# Face frames: (center, ex, ey) such that the cube face is
# {center + u*ex + v*ey : u,v in [-1,1]} and ex x ey == center (outward CCW).
# This embedding satisfies the twelve FV3 mosaic contacts, e.g.
# face0 E <-> face1 W, face0 N <-> face2 W, face0 W <-> face4 N, ...
_X, _Y, _Z = np.eye(3)
FACE_FRAMES: Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray], ...] = (
    (_X, _Y, _Z),  # face 0: equatorial
    (_Y, -_X, _Z),  # face 1: equatorial
    (_Z, -_X, -_Y),  # face 2: north-polar cap
    (-_X, -_Z, -_Y),  # face 3: equatorial (rotated)
    (-_Y, -_Z, _X),  # face 4: equatorial (rotated)
    (-_Z, _Y, _X),  # face 5: south-polar cap
)


@dataclasses.dataclass(frozen=True)
class EdgeLink:
    """Adjacency of one face edge.

    Attributes:
        face: this face index (0..5)
        edge: this edge (EDGE_W/E/S/N)
        nbr_face: the neighboring face across this edge
        nbr_edge: which edge of the neighbor touches this edge
        flip: True if the along-edge index runs in opposite directions on
            the two faces
        rot: number of counterclockwise quarter-turns that take the
            neighbor's index frame into this face's frame.  A vector
            (u, v) in the neighbor's (i, j) components becomes
            ``rot_ccw^rot (u, v)`` in this face's components, where one CCW
            quarter turn maps (u, v) -> (-v, u).
    """

    face: int
    edge: int
    nbr_face: int
    nbr_edge: int
    flip: bool
    rot: int


def _edge_endpoints(face: int, edge: int):
    """3D endpoints of a face edge, ordered by increasing along-edge index."""
    c, ex, ey = FACE_FRAMES[face]
    if edge == EDGE_W:
        return c - ex - ey, c - ex + ey
    if edge == EDGE_E:
        return c + ex - ey, c + ex + ey
    if edge == EDGE_S:
        return c - ex - ey, c + ex - ey
    return c - ex + ey, c + ex + ey


# In index space (i along ex, j along ey): unit 2-vectors.
_ALONG = {EDGE_W: (0, 1), EDGE_E: (0, 1), EDGE_S: (1, 0), EDGE_N: (1, 0)}
_OUTWARD = {EDGE_W: (-1, 0), EDGE_E: (1, 0), EDGE_S: (0, -1), EDGE_N: (0, 1)}


def _rot_from_matrix(m: np.ndarray) -> int:
    """Number of CCW quarter turns represented by a signed permutation 2x2."""
    for r in range(4):
        c, s = [(1, 0), (0, 1), (-1, 0), (0, -1)][r]
        if np.array_equal(m, np.array([[c, -s], [s, c]])):
            return r
    raise ValueError(f"not a rotation matrix: {m}")


@lru_cache(maxsize=None)
def edge_links() -> Tuple[EdgeLink, ...]:
    """All 24 directed edge links of the cube, derived from FACE_FRAMES."""
    links = []
    for f in range(6):
        for e in range(4):
            a0, a1 = _edge_endpoints(f, e)
            found = None
            for g in range(6):
                if g == f:
                    continue
                for e2 in range(4):
                    b0, b1 = _edge_endpoints(g, e2)
                    if np.allclose(a0, b0) and np.allclose(a1, b1):
                        found = (g, e2, False)
                    elif np.allclose(a0, b1) and np.allclose(a1, b0):
                        found = (g, e2, True)
            if found is None:
                raise RuntimeError(f"face {f} edge {e}: no neighbor found")
            g, e2, flip = found
            # Signed permutation taking neighbor (i,j) components to ours:
            # our along-edge axis corresponds to neighbor's along-edge axis
            # (negated if flip); our outward axis corresponds to the
            # neighbor's *inward* axis.
            along_f = np.array(_ALONG[e])
            out_f = np.array(_OUTWARD[e])
            along_g = np.array(_ALONG[e2]) * (-1 if flip else 1)
            in_g = -np.array(_OUTWARD[e2])
            # M maps neighbor components -> our components:
            # M @ along_g = along_f ; M @ in_g = out_f
            basis_g = np.stack([along_g, in_g], axis=1)  # columns
            basis_f = np.stack([along_f, out_f], axis=1)
            m = basis_f @ np.linalg.inv(basis_g)
            m = np.rint(m).astype(int)
            rot = _rot_from_matrix(m)
            links.append(EdgeLink(f, e, g, e2, flip, rot))
    return tuple(links)


@lru_cache(maxsize=None)
def _link_table():
    table = {}
    for l in edge_links():
        table[(l.face, l.edge)] = l
    return table


def link(face: int, edge: int) -> EdgeLink:
    return _link_table()[(face, edge)]


def _cell_of(edge: int, depth: int, along: int, n: int):
    """(j, i) of the interior cell at `depth` rows from `edge`, position
    `along` measured in the along-edge index direction, on an n x n face."""
    if edge == EDGE_W:
        return along, depth
    if edge == EDGE_E:
        return along, n - 1 - depth
    if edge == EDGE_S:
        return depth, along
    return n - 1 - depth, along


@lru_cache(maxsize=None)
def halo_source_indices(n: int, h: int):
    """Gather-index tables for a cell-centered scalar halo exchange.

    For each face, every position of the padded (n+2h, n+2h) array is
    assigned a source cell (face, j, i) in the unpadded [6, n, n] cube.
    Interior positions map to themselves.  Edge-halo positions map to the
    neighboring face's interior cells per the FV3 topology.  Corner-halo
    positions (outside the cube's faces -- three faces meet at each cube
    corner, so there is no unique source) map to the nearest valid edge/
    interior cell and are flagged in the returned mask; stencil code must
    not consume them without an explicit corner fill.

    Returns:
        src_face, src_j, src_i: int32 arrays of shape (6, n+2h, n+2h)
        corner_mask: bool array (6, n+2h, n+2h), True where the value is
            NOT defined by the scalar exchange (cube-corner regions).
    """
    np_ = n + 2 * h
    src_face = np.empty((6, np_, np_), dtype=np.int32)
    src_j = np.empty((6, np_, np_), dtype=np.int32)
    src_i = np.empty((6, np_, np_), dtype=np.int32)
    corner_mask = np.zeros((6, np_, np_), dtype=bool)

    jj, ii = np.meshgrid(np.arange(np_), np.arange(np_), indexing="ij")
    interior = (
        (jj >= h) & (jj < h + n) & (ii >= h) & (ii < h + n)
    )

    for f in range(6):
        # interior: identity
        src_face[f] = f
        src_j[f] = np.clip(jj - h, 0, n - 1)
        src_i[f] = np.clip(ii - h, 0, n - 1)
        corner_mask[f] = ~interior  # start: everything outside is undefined

        for e in range(4):
            l = link(f, e)
            for depth in range(h):
                for along in range(n):
                    # position of this halo slot in the padded array
                    if e == EDGE_W:
                        jp, ip = h + along, h - 1 - depth
                    elif e == EDGE_E:
                        jp, ip = h + along, h + n + depth
                    elif e == EDGE_S:
                        jp, ip = h - 1 - depth, h + along
                    else:
                        jp, ip = h + n + depth, h + along
                    along_g = (n - 1 - along) if l.flip else along
                    gj, gi = _cell_of(l.nbr_edge, depth, along_g, n)
                    src_face[f, jp, ip] = l.nbr_face
                    src_j[f, jp, ip] = gj
                    src_i[f, jp, ip] = gi
                    corner_mask[f, jp, ip] = False
    return src_face, src_j, src_i, corner_mask


def _edge_map_affine(l: EdgeLink, n: int):
    """The halo map of link l as an affine function of (J, I).

    Maps a halo cell index (J, I) of face l.face (one coordinate out of
    [0, n)) to the neighbor cell (l.nbr_face, J', I').  Returned as
    (A, b): [J', I'] = A @ [J, I] + b, valid for slots beyond edge l.edge.
    Being affine, it can be *extended* beyond its nominal domain -- which
    is how cube-corner cells are resolved (see resolve_corner_cell).
    """

    def neg(t):
        # affine map x -> n - 1 - x on a coefficient triple (cJ, cI, c0)
        return (-t[0], -t[1], n - 1 - t[2])

    # depth/along of the halo slot as affine triples (cJ, cI, const)
    if l.edge == EDGE_W:
        depth, along = (0, -1, -1), (1, 0, 0)
    elif l.edge == EDGE_E:
        depth, along = (0, 1, -n), (1, 0, 0)
    elif l.edge == EDGE_S:
        depth, along = (-1, 0, -1), (0, 1, 0)
    else:
        depth, along = (1, 0, -n), (0, 1, 0)
    if l.flip:
        along = neg(along)
    # neighbor cell (J', I') from (depth, along) per _cell_of
    e2 = l.nbr_edge
    if e2 == EDGE_W:
        j_aff, i_aff = along, depth
    elif e2 == EDGE_E:
        j_aff, i_aff = along, neg(depth)
    elif e2 == EDGE_S:
        j_aff, i_aff = depth, along
    else:
        j_aff, i_aff = neg(depth), along
    A = np.array([[j_aff[0], j_aff[1]], [i_aff[0], i_aff[1]]])
    b = np.array([j_aff[2], i_aff[2]])
    return A, b


def resolve_corner_cell(face: int, J: int, I: int, n: int, first: str):
    """Resolve a cube-corner halo slot to a real cell on the third face.

    (J, I) has BOTH coordinates outside [0, n).  `first` selects which
    axis's edge map is applied first, which disambiguates the corner:
    'y' gives row continuation (x-sweep semantics: the row belongs to the
    y-neighbor; extend it sideways across that face's edge), 'x' gives
    column continuation.  This generalizes FV3's copy_corners mirror fill
    (tp_core.F90) with the *true* third-face cells, which the full-cube
    layout has available.
    """
    if first == "y":
        e1 = EDGE_S if J < 0 else EDGE_N
    else:
        e1 = EDGE_W if I < 0 else EDGE_E
    l1 = link(face, e1)
    A, b = _edge_map_affine(l1, n)
    J2, I2 = A @ np.array([J, I]) + b
    g = l1.nbr_face
    # exactly one coordinate of (J2, I2) is out of range now
    out_j = not (0 <= J2 < n)
    out_i = not (0 <= I2 < n)
    if out_j == out_i:
        raise ValueError(
            f"corner resolution failed at face {face} ({J},{I}): "
            f"-> face {g} ({J2},{I2})"
        )
    if out_j:
        e2 = EDGE_S if J2 < 0 else EDGE_N
    else:
        e2 = EDGE_W if I2 < 0 else EDGE_E
    l2 = link(g, e2)
    A2, b2 = _edge_map_affine(l2, n)
    J3, I3 = A2 @ np.array([J2, I2]) + b2
    if not (0 <= J3 < n and 0 <= I3 < n):
        raise ValueError(
            f"corner resolution escaped face {l2.nbr_face}: ({J3},{I3})"
        )
    return l2.nbr_face, int(J3), int(I3)


@lru_cache(maxsize=None)
def halo_source_indices_filled(n: int, h: int, fill: str):
    """Like halo_source_indices but with cube-corner slots resolved.

    fill='x': corners resolved by row continuation (use before x-sweep
    stencils / after the inner-y operator, mirroring FV3 copy_corners
    dir=1 semantics); fill='y': column continuation (dir=2).
    """
    assert fill in ("x", "y")
    src_face, src_j, src_i, corner_mask = (
        a.copy() for a in halo_source_indices(n, h)
    )
    first = "y" if fill == "x" else "x"
    for f in range(6):
        for Jp in range(n + 2 * h):
            for Ip in range(n + 2 * h):
                if not corner_mask[f, Jp, Ip]:
                    continue
                J, I = Jp - h, Ip - h
                gf, gJ, gI = resolve_corner_cell(f, J, I, n, first)
                src_face[f, Jp, Ip] = gf
                src_j[f, Jp, Ip] = gJ
                src_i[f, Jp, Ip] = gI
    return src_face, src_j, src_i, corner_mask


# 1-based FMS mosaic contact list, used by tests to pin the derived topology
# to the arrangement the reference encodes in FV3_FACE_CONNECTIONS
# (external/vcm/vcm/cubedsphere/xgcm.py:6-35).  Entries: (face, edge) pairs.
KNOWN_CONTACTS = [
    ((0, EDGE_E), (1, EDGE_W)),
    ((0, EDGE_N), (2, EDGE_W)),
    ((0, EDGE_W), (4, EDGE_N)),
    ((0, EDGE_S), (5, EDGE_N)),
    ((1, EDGE_N), (2, EDGE_S)),
    ((1, EDGE_E), (3, EDGE_S)),
    ((1, EDGE_S), (5, EDGE_E)),
    ((2, EDGE_E), (3, EDGE_W)),
    ((2, EDGE_N), (4, EDGE_W)),
    ((3, EDGE_N), (4, EDGE_S)),
    ((3, EDGE_E), (5, EDGE_S)),
    ((4, EDGE_E), (5, EDGE_W)),
]
