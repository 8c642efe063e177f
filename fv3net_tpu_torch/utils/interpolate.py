"""Vertical interpolation utilities (vcm/interpolate.py equivalents; the
JAX package's ``utils/interpolate.py``).

``interpolate_1d`` and ``interpolate_to_pressure_levels`` take host
arrays or tensors and interpolate with ``ops.remap.interpolate_columns``
on a torch device: the tensors' own, or ``device`` for host arrays (the
CUDA device unless the caller names another, ``device="cpu"``).  They
return host arrays, as the JAX package's do.  ``interpolate_unstructured``
is host code (scipy's cKDTree), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import device_for
from ..ops.remap import interpolate_columns
from .thermo import pressure_at_midpoint_log

# the reference's standard pressure grid for diagnostics
# (vcm/interpolate.py PRESSURE_GRID, hPa -> Pa)
PRESSURE_GRID = 100.0 * np.array(
    [1000, 925, 850, 700, 600, 500, 400, 300, 250, 200, 150, 100, 70,
     50, 30, 20, 10]
)[::-1]


def interpolate_1d(xp, x, y, axis=-3, fill_value=np.nan, device=None):
    """Columnwise linear interpolation (vcm/interpolate.py:100; backed by
    the same algorithm the reference wraps from interpolate_2d.f90), on
    the tensors' device, or for host arrays `device` (default: the CUDA
    device); returns a host array."""
    dev = device_for((xp, x, y), device, "interpolate_1d")

    def col(a):
        if not isinstance(a, torch.Tensor):
            a = np.ascontiguousarray(a)
        return torch.movedim(torch.as_tensor(a, device=dev), axis, 0)

    out = interpolate_columns(col(xp), col(x), col(y),
                              fill_value=fill_value)
    return torch.movedim(out, 0, axis).cpu().numpy()


def interpolate_to_pressure_levels(
    field, delp, levels=PRESSURE_GRID, axis=-3, toa_pressure=300.0,
    device=None,
):
    """(vcm/interpolate.py:77): interpolate a field from model levels to
    fixed pressure levels using log-midpoint pressures, on `device` (see
    ``interpolate_1d``)."""
    pmid = pressure_at_midpoint_log(delp, toa_pressure, axis)
    shape = list(np.shape(field))
    shape[axis % len(shape)] = len(levels)
    lev = np.asarray(levels, dtype=np.float64)
    expand = [1] * len(shape)
    expand[axis % len(shape)] = len(levels)
    target = np.broadcast_to(
        lev.reshape(expand), shape
    )
    return interpolate_1d(target, pmid, field, axis=axis, device=device)


def interpolate_unstructured(data, coords):
    """(vcm/interpolate.py:246): interpolate fields sampled at
    unstructured points onto target points by nearest neighbor.

    data: mapping name -> array [..., n_points] (trailing axis is the
    sample axis); coords: mapping coord_name -> (source_points,
    target_points) pairs of 1D arrays (e.g. {"lon": (src_lon, tgt_lon),
    "lat": (src_lat, tgt_lat)}).  Lon/lat coords (degrees) are matched
    on the unit sphere; other coords euclidean.  Returns mapping of
    name -> array [..., n_targets].
    """
    from scipy.spatial import cKDTree

    # lon/lat keys are matched case-insensitively so e.g. "LON"/"Lat"
    # take the spherical path rather than silently dropping out
    lon = lat = None
    angular_keys = set()
    for name, pair in coords.items():
        low = name.lower()
        if low in ("lon", "longitude") and lon is None:
            lon, _k = pair, angular_keys.add(name)
        elif low in ("lat", "latitude") and lat is None:
            lat, _k = pair, angular_keys.add(name)
    if (lon is None) != (lat is None):
        # an unpaired lon or lat falls back to a euclidean column
        angular_keys.clear()
        lon = lat = None

    src_cols, tgt_cols = [], []
    for name, (src, tgt) in coords.items():
        if name in angular_keys:
            continue  # handled jointly below
        src = np.asarray(src, float)
        tgt = np.asarray(tgt, float)
        # normalize so an O(1e5) coord (pressure) cannot dominate the
        # O(1) unit-sphere columns in the KDTree metric
        scale = np.std(src)
        scale = scale if scale > 0 else 1.0
        src_cols.append(src[:, None] / scale)
        tgt_cols.append(tgt[:, None] / scale)
    if lon is not None and lat is not None:
        def xyz(lo, la):
            lo = np.deg2rad(np.asarray(lo, float))
            la = np.deg2rad(np.asarray(la, float))
            return np.stack(
                [np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo),
                 np.sin(la)], axis=-1,
            )

        src_cols.append(xyz(lon[0], lat[0]))
        tgt_cols.append(xyz(lon[1], lat[1]))
    src_pts = np.concatenate(src_cols, axis=-1)
    tgt_pts = np.concatenate(tgt_cols, axis=-1)
    _, nearest = cKDTree(src_pts).query(tgt_pts)
    return {
        name: np.asarray(arr)[..., nearest]
        for name, arr in data.items()
    }
