"""Lat-lon wind rotation (external/vcm/vcm/cubedsphere/rotate.py; a copy
of the JAX package's ``utils/rotate.py``, numpy).

The reference rotates D-grid x/y winds to A-grid eastward/northward
winds with a precomputed wind-rotation-matrix dataset (four coefficient
fields, rotate.py:9-57, loaded from the catalog).  Here the matrix is
derived directly from the cubed-sphere geometry (local east/north unit
vectors dotted with the grid's x/y directions at cell centers), then
applied with the same two-step recipe: shift edge winds to centers,
rotate.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np


def wind_rotation_matrix(grid) -> Dict[str, np.ndarray]:
    """The four rotation coefficients at cell centers
    (the catalog's wind_rotation_matrix entries): e/n components of the
    local x and y grid directions."""
    # derive x/y grid directions from cell-center positions, project
    # onto the local east/north basis
    s = grid.interior + (np.s_[:],)
    xyz = np.asarray(grid.centers_xyz[s])
    x_dir = np.gradient(xyz, axis=2)
    y_dir = np.gradient(xyz, axis=1)
    ee = np.asarray(grid.e_east[s])
    en = np.asarray(grid.e_north[s])

    def unit(v):
        return v / np.maximum(
            np.linalg.norm(v, axis=-1, keepdims=True), 1e-30
        )

    x_dir, y_dir = unit(x_dir), unit(y_dir)
    # the x/y components are projections of the wind onto the grid
    # directions; invert that 2x2 system per cell (non-orthogonal
    # grids make the transpose wrong near cube corners)
    a = (ee * x_dir).sum(-1)  # east contribution to x component
    b = (en * x_dir).sum(-1)
    c = (ee * y_dir).sum(-1)
    d = (en * y_dir).sum(-1)
    det = a * d - b * c
    return {
        "eastward_wind_u_coeff": d / det,
        "eastward_wind_v_coeff": -b / det,
        "northward_wind_u_coeff": -c / det,
        "northward_wind_v_coeff": a / det,
    }


def shift_edge_var_to_center(arr: np.ndarray) -> np.ndarray:
    """Average the single staggered dim to centers
    (vcm/cubedsphere/coarsen.py shift_edge_var_to_center): accepts
    [..., y+1, x] or [..., y, x+1]."""
    if arr.shape[-2] == arr.shape[-1] + 1:
        return 0.5 * (arr[..., 1:, :] + arr[..., :-1, :])
    if arr.shape[-1] == arr.shape[-2] + 1:
        return 0.5 * (arr[..., :, 1:] + arr[..., :, :-1])
    raise ValueError(
        f"no single staggered dimension in shape {arr.shape}"
    )


def rotate_xy_winds(
    matrix: Mapping[str, np.ndarray],
    x_wind_centered: np.ndarray,
    y_wind_centered: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """(rotate.py:40-57)"""
    lead = x_wind_centered.ndim - matrix["eastward_wind_u_coeff"].ndim

    def bc(c):
        return c[(slice(None),) + (None,) * lead] if lead else c

    east = (
        bc(matrix["eastward_wind_u_coeff"]) * x_wind_centered
        + bc(matrix["eastward_wind_v_coeff"]) * y_wind_centered
    )
    north = (
        bc(matrix["northward_wind_u_coeff"]) * x_wind_centered
        + bc(matrix["northward_wind_v_coeff"]) * y_wind_centered
    )
    return east, north


def center_and_rotate_xy_winds(
    matrix: Mapping[str, np.ndarray],
    x_component: np.ndarray,
    y_component: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """D-grid x/y winds [..., y+1, x] / [..., y, x+1] -> centered
    eastward/northward (rotate.py:9-37)."""
    xc = shift_edge_var_to_center(x_component)
    yc = shift_edge_var_to_center(y_component)
    return rotate_xy_winds(matrix, xc, yc)
