"""Cube-face pcolormesh with dateline masking (fv3viz/_plot_cube.py
semantics: pcolormesh_cube `:245` masks cells whose corners straddle
the periodic longitude seam so each face draws without wrap artifacts;
plot_cube `:54` is the high-level facade; infer_cmap_params follows
the xarray robust-percentile + diverging-detection rules of
fv3viz/_plot_helpers.py)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def infer_cmap_params(
    data,
    vmin=None,
    vmax=None,
    cmap=None,
    robust: bool = False,
):
    """(fv3viz/_plot_helpers.py): choose vmin/vmax/cmap.

    Diverging data (spanning zero) gets a symmetric RdBu_r scale;
    robust=True uses the 2nd/98th percentiles."""
    finite = np.asarray(data)[np.isfinite(np.asarray(data))]
    if finite.size == 0:
        return {"vmin": 0.0, "vmax": 1.0, "cmap": cmap or "viridis"}
    if robust:
        calc_vmin = np.percentile(finite, 2)
        calc_vmax = np.percentile(finite, 98)
    else:
        calc_vmin = finite.min()
        calc_vmax = finite.max()
    diverging = calc_vmin < 0 < calc_vmax and vmin is None \
        and vmax is None
    if diverging:
        bound = max(abs(calc_vmin), abs(calc_vmax))
        vmin, vmax = -bound, bound
        cmap = cmap or "RdBu_r"
    else:
        vmin = calc_vmin if vmin is None else vmin
        vmax = calc_vmax if vmax is None else vmax
        cmap = cmap or "viridis"
    return {"vmin": float(vmin), "vmax": float(vmax), "cmap": cmap}


def _mask_wrap_cells(lon_b_deg, data):
    """NaN-mask cells whose corner longitudes straddle the 0/360 seam
    (fv3viz masks these per central_longitude, _plot_cube.py:283+)."""
    corners = np.stack(
        [
            lon_b_deg[:-1, :-1], lon_b_deg[:-1, 1:],
            lon_b_deg[1:, :-1], lon_b_deg[1:, 1:],
        ]
    )
    span = corners.max(axis=0) - corners.min(axis=0)
    out = np.array(data, dtype=float)
    out[span > 180.0] = np.nan
    return out


def pcolormesh_cube(lat_b, lon_b, data, ax=None, **kwargs):
    """(fv3viz/_plot_cube.py:245): draw all 6 faces of [6, n, n] data
    given corner lats/lons [6, n+1, n+1] (degrees).  Returns the last
    matplotlib QuadMesh handle (shared norm across faces)."""
    import matplotlib.pyplot as plt

    if ax is None:
        ax = plt.gca()
    lat_b = np.asarray(lat_b)
    lon_b = np.asarray(lon_b)
    data = np.asarray(data)
    if "vmin" not in kwargs or "vmax" not in kwargs:
        params = infer_cmap_params(
            data, kwargs.get("vmin"), kwargs.get("vmax"),
            kwargs.get("cmap"),
        )
        kwargs = {**params, **{
            k: v for k, v in kwargs.items() if v is not None
        }}
    handle = None
    for face in range(6):
        masked = _mask_wrap_cells(lon_b[face], data[face])
        handle = ax.pcolormesh(
            lon_b[face], lat_b[face], masked, **kwargs
        )
    ax.set_xlim(0, 360)
    ax.set_ylim(-90, 90)
    return handle


def plot_cube(
    data,
    grid=None,
    ax=None,
    colorbar: bool = True,
    title: Optional[str] = None,
    **kwargs,
):
    """(fv3viz/_plot_cube.py:54): high-level map of a [6, n, n] cube
    field.  `grid` is a CubedSphereGrid (built at the matching n if
    omitted).  Returns (fig, ax, handle)."""
    import matplotlib.pyplot as plt

    from ..grid import CubedSphereGrid

    data = np.asarray(data)
    if grid is None:
        grid = CubedSphereGrid.make(data.shape[-1], halo=0)
    if ax is None:
        fig, ax = plt.subplots(figsize=(8, 4))
    else:
        fig = ax.figure
    handle = pcolormesh_cube(
        np.rad2deg(grid.lat_b), np.rad2deg(grid.lon_b), data, ax=ax,
        **kwargs,
    )
    if colorbar:
        fig.colorbar(handle, ax=ax)
    if title:
        ax.set_title(title)
    ax.set_xlabel("longitude")
    ax.set_ylabel("latitude")
    return fig, ax, handle
