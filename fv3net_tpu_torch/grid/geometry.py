"""Gnomonic cubed-sphere grid geometry.

Builds the equiangular gnomonic grid on the six faces defined by
``topology.FACE_FRAMES``, including *extended* corner lattices that continue
into the halo region using the neighboring faces' actual grid points, so
that every metric term (edge length, cell area) computed in the halo is
bit-identical to the neighbor's interior value -- the property FV3's
Fortran grid halo update establishes via FMS.

All of this is setup-time numpy (float64); the resulting ``CubedSphereGrid``
holds numpy arrays that the solver's metric setup reads.  Grid
semantics follow the reference's ``external/vcm/vcm/grid.py`` (lon/lat
<-> xyz maps) and the FMS gnomonic grid generator it relies on.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

from ..constants import OMEGA, PI, RADIUS
from . import topology as topo


def lonlat_from_xyz(xyz: np.ndarray):
    """(lon, lat) from unit vectors; lon in [0, 2pi)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lon = np.arctan2(y, x)
    lon = np.where(lon < 0, lon + 2 * PI, lon)
    lat = np.arcsin(np.clip(z, -1, 1))
    return lon, lat


def xyz_from_lonlat(lon, lat):
    return np.stack(
        [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)],
        axis=-1,
    )


def _normalize(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def face_point(face: int, alpha, beta) -> np.ndarray:
    """Unit-sphere point at equiangular coords (alpha, beta) on a face.

    alpha, beta in [-pi/4, pi/4] cover the face; values outside continue
    the gnomonic projection beyond the face boundary (used only for
    diagnostics -- halo points use the neighbor's own formula instead).
    """
    c, ex, ey = topo.FACE_FRAMES[face]
    alpha = np.asarray(alpha, dtype=np.float64)
    beta = np.asarray(beta, dtype=np.float64)
    p = (
        c
        + np.tan(alpha)[..., None] * ex
        + np.tan(beta)[..., None] * ey
    )
    return _normalize(p)


def gnomonic_grid(n: int) -> np.ndarray:
    """Cell-corner unit vectors, shape [6, n+1, n+1, 3] indexed [face,J,I]."""
    edges = np.linspace(-PI / 4, PI / 4, n + 1)
    beta, alpha = np.meshgrid(edges, edges, indexing="ij")
    return np.stack([face_point(f, alpha, beta) for f in range(6)])


@lru_cache(maxsize=None)
def _corner_index_maps(n: int, h: int):
    """Maps padded corner lattice positions to (face, J, I) source corners.

    Padded lattice has shape (n+2h+1, n+2h+1) per face; position (Jp, Ip)
    corresponds to global corner index (J, I) = (Jp-h, Ip-h) which may lie
    beyond the face.  Returns (src_face, src_J, src_I, defined) arrays of
    shape (6, n+2h+1, n+2h+1); `defined` is False in the cube-corner
    regions where no single neighbor provides the point.
    """
    m = n + 2 * h + 1
    src_face = np.zeros((6, m, m), dtype=np.int32)
    src_J = np.zeros((6, m, m), dtype=np.int32)
    src_I = np.zeros((6, m, m), dtype=np.int32)
    defined = np.zeros((6, m, m), dtype=bool)

    def nbr_corner(l: topo.EdgeLink, depth: int, along: int):
        """Corner on l.nbr_face at `depth` beyond l's edge, `along` on it."""
        p = (n - along) if l.flip else along
        e2 = l.nbr_edge
        if e2 == topo.EDGE_W:
            return p, depth
        if e2 == topo.EDGE_E:
            return p, n - depth
        if e2 == topo.EDGE_S:
            return depth, p
        return n - depth, p

    for f in range(6):
        for Jp in range(m):
            for Ip in range(m):
                J, I = Jp - h, Ip - h
                inside_J = 0 <= J <= n
                inside_I = 0 <= I <= n
                if inside_J and inside_I:
                    src_face[f, Jp, Ip] = f
                    src_J[f, Jp, Ip], src_I[f, Jp, Ip] = J, I
                    defined[f, Jp, Ip] = True
                elif inside_J != inside_I:
                    if not inside_I:
                        edge = topo.EDGE_W if I < 0 else topo.EDGE_E
                        depth, along = (-I if I < 0 else I - n), J
                    else:
                        edge = topo.EDGE_S if J < 0 else topo.EDGE_N
                        depth, along = (-J if J < 0 else J - n), I
                    l = topo.link(f, edge)
                    gJ, gI = nbr_corner(l, depth, along)
                    src_face[f, Jp, Ip] = l.nbr_face
                    src_J[f, Jp, Ip], src_I[f, Jp, Ip] = gJ, gI
                    defined[f, Jp, Ip] = True
                # else: cube-corner region, undefined
    return src_face, src_J, src_I, defined


def extended_corners(n: int, h: int) -> np.ndarray:
    """Corner lattice [6, n+2h+1, n+2h+1, 3] extended h cells into halos.

    Halo corners are the *actual* grid points of the neighboring faces
    (not gnomonic extrapolations), so halo metric terms computed from them
    match the neighbors' interior values exactly.  Cube-corner regions are
    NaN.
    """
    base = gnomonic_grid(n)
    src_face, src_J, src_I, defined = _corner_index_maps(n, h)
    out = base[src_face, src_J, src_I]
    out = np.where(defined[..., None], out, np.nan)
    return out


def _gc_distance(a, b):
    """Great-circle distance between unit vectors (radius 1)."""
    cross = np.linalg.norm(np.cross(a, b), axis=-1)
    dot = np.sum(a * b, axis=-1)
    return np.arctan2(cross, dot)


def _corner_angle(b, a, c):
    """Interior spherical angle at vertex b of the arc a-b-c."""
    ta = a - np.sum(a * b, axis=-1, keepdims=True) * b
    tc = c - np.sum(c * b, axis=-1, keepdims=True) * b
    ta = ta / np.maximum(np.linalg.norm(ta, axis=-1, keepdims=True), 1e-300)
    tc = tc / np.maximum(np.linalg.norm(tc, axis=-1, keepdims=True), 1e-300)
    return np.arccos(np.clip(np.sum(ta * tc, axis=-1), -1.0, 1.0))


def quad_area(sw, se, ne, nw):
    """Spherical-excess area of quads on the unit sphere."""
    ang = (
        _corner_angle(sw, nw, se)
        + _corner_angle(se, sw, ne)
        + _corner_angle(ne, se, nw)
        + _corner_angle(nw, ne, sw)
    )
    return ang - 2 * PI


def cell_centers(corners: np.ndarray) -> np.ndarray:
    """Cell centers as the normalized mean of the 4 surrounding corners.

    Matches the semantics of the reference's coarsening-based center
    calculation (external/vcm/vcm/grid.py:83-92).
    """
    c = (
        corners[..., :-1, :-1, :]
        + corners[..., :-1, 1:, :]
        + corners[..., 1:, :-1, :]
        + corners[..., 1:, 1:, :]
    )
    return _normalize(c)


@dataclasses.dataclass(frozen=True)
class CubedSphereGrid:
    """Static grid data for an n x n x 6 cubed sphere with halo width h.

    All 2D arrays are *padded*: cell-centered arrays have shape
    [6, n+2h, n+2h], corner arrays [6, n+2h+1, n+2h+1]; interior starts at
    offset h.  Cube-corner halo regions hold NaN (corners_xyz) or 0/1
    neutral values (metrics) and must not be consumed without a corner
    fill.

    Metric terms follow FV3 naming:
        area   cell area (m^2), cell-centered
        dx     along-x edge length (m) at corner rows: [6, N+1, N] rows of
               x-edges (between corners (J,I) and (J,I+1))
        dy     along-y edge length (m): [6, N, N+1]
        dxa/dya  A-grid cell widths (m), cell-centered
        dxc    distance between adjacent cell centers across x: [6, N, N+1]
        dyc    [6, N+1, N]
        area_c dual-cell (corner) area (m^2): [6, N+1, N+1]
    where N = n + 2h.
    """

    n: int
    halo: int
    corners_xyz: np.ndarray  # [6, N+1, N+1, 3]
    centers_xyz: np.ndarray  # [6, N, N, 3]
    lon: np.ndarray  # cell centers [6, N, N]
    lat: np.ndarray
    lon_b: np.ndarray  # corners [6, N+1, N+1]
    lat_b: np.ndarray
    area: np.ndarray  # [6, N, N]
    dx: np.ndarray  # [6, N+1, N]
    dy: np.ndarray  # [6, N, N+1]
    dxa: np.ndarray  # [6, N, N]
    dya: np.ndarray
    dxc: np.ndarray  # [6, N, N+1]
    dyc: np.ndarray  # [6, N+1, N]
    area_c: np.ndarray  # [6, N+1, N+1]
    f_corner: np.ndarray  # Coriolis parameter at corners [6, N+1, N+1]
    f_center: np.ndarray  # at centers [6, N, N]
    e_east: np.ndarray  # local unit east at centers [6, N, N, 3]
    e_north: np.ndarray  # local unit north at centers [6, N, N, 3]

    @property
    def interior(self):
        """Slice selecting the interior of a padded cell-centered array."""
        h = self.halo
        return np.s_[..., h : h + self.n, h : h + self.n]

    @classmethod
    def make(cls, n: int, halo: int = 3) -> "CubedSphereGrid":
        h = halo
        corners = extended_corners(n, h)  # [6, N+1, N+1, 3], NaN corners
        centers = cell_centers(corners)
        lon_b, lat_b = lonlat_from_xyz(corners)
        lon, lat = lonlat_from_xyz(centers)

        # metrics (NaN propagates into cube-corner regions; replaced below)
        dx = _gc_distance(corners[:, :, :-1], corners[:, :, 1:]) * RADIUS
        dy = _gc_distance(corners[:, :-1, :], corners[:, 1:, :]) * RADIUS
        area = (
            quad_area(
                corners[:, :-1, :-1],
                corners[:, :-1, 1:],
                corners[:, 1:, 1:],
                corners[:, 1:, :-1],
            )
            * RADIUS ** 2
        )
        # A-grid widths: distance between midpoints of opposite edges
        mid_w = _normalize(corners[:, :-1, :, :] + corners[:, 1:, :, :])
        mid_s = _normalize(corners[:, :, :-1, :] + corners[:, :, 1:, :])
        dxa = _gc_distance(mid_w[:, :, :-1], mid_w[:, :, 1:]) * RADIUS
        dya = _gc_distance(mid_s[:, :-1, :], mid_s[:, 1:, :]) * RADIUS
        # C-grid: center-to-center distances
        dxc_int = _gc_distance(centers[:, :, :-1], centers[:, :, 1:]) * RADIUS
        dyc_int = _gc_distance(centers[:, :-1, :], centers[:, 1:, :]) * RADIUS
        N = n + 2 * h
        dxc = np.full((6, N, N + 1), np.nan)
        dxc[:, :, 1:-1] = dxc_int
        dyc = np.full((6, N + 1, N), np.nan)
        dyc[:, 1:-1, :] = dyc_int
        # dual-cell area around each corner: quad of the 4 adjacent centers
        area_c = np.full((6, N + 1, N + 1), np.nan)
        area_c[:, 1:-1, 1:-1] = (
            quad_area(
                centers[:, :-1, :-1],
                centers[:, :-1, 1:],
                centers[:, 1:, 1:],
                centers[:, 1:, :-1],
            )
            * RADIUS ** 2
        )

        f_corner = 2 * OMEGA * np.sin(lat_b)
        f_center = 2 * OMEGA * np.sin(lat)

        # local east/north unit vectors at cell centers
        z = np.array([0.0, 0.0, 1.0])
        east = np.cross(np.broadcast_to(z, centers.shape), centers)
        east = east / np.maximum(
            np.linalg.norm(east, axis=-1, keepdims=True), 1e-300
        )
        north = np.cross(centers, east)

        def clean(a, fill=1.0):
            return np.where(np.isfinite(a), a, fill)

        return cls(
            n=n,
            halo=h,
            corners_xyz=corners,
            centers_xyz=centers,
            lon=clean(lon, 0.0),
            lat=clean(lat, 0.0),
            lon_b=clean(lon_b, 0.0),
            lat_b=clean(lat_b, 0.0),
            area=clean(area),
            dx=clean(dx),
            dy=clean(dy),
            dxa=clean(dxa),
            dya=clean(dya),
            dxc=clean(dxc),
            dyc=clean(dyc),
            area_c=clean(area_c),
            f_corner=clean(f_corner, 0.0),
            f_center=clean(f_center, 0.0),
            e_east=east,
            e_north=north,
        )
