"""Diagnostic input transforms (a copy of the JAX package's
``diagnostics/transforms.py``;
workflows/diagnostics/fv3net/diagnostics/prognostic_run/transform.py
equivalent).

The reference decorates each registered diagnostic with reusable
transforms — daily/hourly resampling, land/sea/tropics area masking,
pressure-level interpolation, time subsets.  Here the same operations
are plain functions over the DiagArg tuple (run dict, verification
dict, grid dict, and the torch device of the pressure-level
interpolation), composed by the compute registry.  Host numpy but for
the interpolation (``utils.interpolate``).
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch


class DiagArg(NamedTuple):
    """prediction, verification (may be empty), grid info, and the
    device of the pressure-level interpolation (None: the CUDA
    device)."""

    prediction: Dict[str, np.ndarray]
    verification: Dict[str, np.ndarray]
    grid: Dict[str, np.ndarray]  # area [tile,y,x], lat, lon (radians),
    # optionally land_sea_mask, delp [time,tile,z,y,x]
    device: Optional[torch.device] = None


TROPICS_LAT = 10.0  # deep tropics band, transform.py mask_area
SURFACE_TYPE_VALUES = {"land": 1, "sea": 0, "seaice": 2}


def mask_area(mask_type: str, grid: Mapping) -> np.ndarray:
    """Area with zeros off-mask (transform.py:mask_area): 'global',
    'land', 'sea', 'tropics', 'tropics20'."""
    area = np.asarray(grid["area"], np.float64)
    if mask_type == "global":
        return area
    if mask_type in ("tropics", "tropics20"):
        lim = 20.0 if mask_type == "tropics20" else TROPICS_LAT
        lat = np.rad2deg(np.asarray(grid["lat"]))
        return np.where(np.abs(lat) <= lim, area, 0.0)
    if mask_type in SURFACE_TYPE_VALUES:
        mask = np.asarray(
            grid.get("land_sea_mask", np.zeros_like(area))
        )
        want = SURFACE_TYPE_VALUES[mask_type]
        return np.where(np.round(mask) == want, area, 0.0)
    raise ValueError(f"unknown mask type {mask_type!r}")


def resample_time(
    run: Mapping[str, np.ndarray], freq_steps: int
) -> Dict[str, np.ndarray]:
    """Block-average the leading time axis every ``freq_steps`` samples
    (the reference's '3H'/'daily' resampling on a uniform dt store)."""
    out = {}
    for name, arr in run.items():
        nt = arr.shape[0] - arr.shape[0] % freq_steps
        if nt == 0:
            out[name] = arr
            continue
        shaped = arr[:nt].reshape(
            (nt // freq_steps, freq_steps) + arr.shape[1:]
        )
        out[name] = shaped.mean(axis=1)
    return out


def weighted_mean(
    arr: np.ndarray, weights: np.ndarray, axes
) -> np.ndarray:
    w = np.broadcast_to(weights, arr.shape)
    denom = w.sum(axis=axes)
    return np.where(
        denom == 0, np.nan, (arr * w).sum(axis=axes) / np.where(
            denom == 0, 1.0, denom
        )
    )


def zonal_average(
    arr: np.ndarray, lat: np.ndarray, area: np.ndarray,
    bins: Optional[np.ndarray] = None,
):
    """Area-weighted approximate zonal average on latitude bands
    (vcm.zonal_average_approximate): arr [..., tile, y, x] ->
    [..., nbins]; returns (band_centers_deg, profile)."""
    if bins is None:
        bins = np.arange(-90.0, 90.1, 4.0)
    latd = np.rad2deg(np.asarray(lat)).ravel()
    flat = arr.reshape(arr.shape[: -3] + (-1,))
    a = np.asarray(area, np.float64).ravel()
    idx = np.clip(np.digitize(latd, bins) - 1, 0, len(bins) - 2)
    nb = len(bins) - 1
    wsum = np.zeros(nb)
    np.add.at(wsum, idx, a)
    prof = np.full(flat.shape[:-1] + (nb,), np.nan)
    num = np.zeros(flat.shape[:-1] + (nb,))
    # accumulate per band with one segment sum over the flattened axis
    for b in range(nb):
        sel = idx == b
        if sel.any() and wsum[b] > 0:
            num[..., b] = (flat[..., sel] * a[sel]).sum(axis=-1)
            prof[..., b] = num[..., b] / wsum[b]
    centers = 0.5 * (bins[:-1] + bins[1:])
    return centers, prof


def interpolate_to_pressure(
    field: np.ndarray, delp: np.ndarray, levels=None, toa_pressure=300.0,
    device=None,
) -> np.ndarray:
    """[..., z, y, x] field onto standard pressure levels
    (vcm interpolate_to_pressure_levels), interpolated on `device` (None:
    the CUDA device)."""
    from ..utils.interpolate import (
        PRESSURE_GRID, interpolate_to_pressure_levels,
    )

    if levels is None:
        levels = PRESSURE_GRID
    return np.asarray(
        interpolate_to_pressure_levels(
            field, delp, levels=levels, toa_pressure=toa_pressure,
            device=device,
        )
    )


def diurnal_cycle(
    arr: np.ndarray, lon: np.ndarray, area: np.ndarray,
    dt_hours: float, n_bins: int = 24, t0_hour: float = 0.0,
):
    """Composite the diurnal cycle in local solar time
    (compute.py:_assign_diurnal_cycle_fraction semantics): arr
    [time, tile, y, x] -> mean value per local-hour bin."""
    nt = arr.shape[0]
    utc_hour = (t0_hour + dt_hours * np.arange(nt)) % 24.0
    local = (
        utc_hour[:, None, None, None]
        + np.rad2deg(lon)[None] / 15.0
    ) % 24.0
    idx = np.minimum((local / (24.0 / n_bins)).astype(int), n_bins - 1)
    w = np.broadcast_to(area[None], arr.shape)
    sums = np.zeros(n_bins)
    wsum = np.zeros(n_bins)
    np.add.at(sums, idx.ravel(), (arr * w).ravel())
    np.add.at(wsum, idx.ravel(), w.ravel())
    return np.where(wsum > 0, sums / np.where(wsum > 0, wsum, 1), np.nan)


def histogram(
    arr: np.ndarray, area: np.ndarray, bins: np.ndarray
):
    """Area-weighted histogram density over all samples
    (compute.py:histogram with TIME_MEAN_VARS bins)."""
    w = np.broadcast_to(area, arr.shape).ravel()
    counts, edges = np.histogram(
        arr.ravel(), bins=bins, weights=w, density=True
    )
    return counts, edges
