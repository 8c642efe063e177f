"""Prognostic-run diagnostics computation (a copy of the JAX package's
``diagnostics/compute.py``;
workflows/diagnostics/fv3net/diagnostics/prognostic_run/compute.py).

The reference registers ~24 diagnostic groups over 2D and 3D run
output — global/masked spatial reductions, zonal means and biases,
pressure-level sections, diurnal cycles, histograms — each produced by
a registry function operating on (prediction, verification, grid).
This module re-creates that registry over numpy arrays from
zarr-lite stores: every group below cites the reference function it
mirrors.  A separate metrics registry (metrics.py here, reference
`prognostic_run/metrics.py`) reduces the computed diagnostics to
scalar metrics consumed by the HTML report.

Conventions: 2D run variables are [time, tile, y, x]; 3D variables are
[time, tile, z, y, x]; verification may be empty (bias groups then
skip); `grid` carries area/lat/lon (+ optional land_sea_mask, delp,
dt_hours).  Every group is host numpy but the pressure-level
interpolation of the 3D groups, which runs on the DiagArg's torch device
(``compute_diagnostics(device=...)``, the CUDA device by default).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..device import default_device
from .registry import Registry
from .transforms import (
    DiagArg,
    diurnal_cycle,
    histogram,
    interpolate_to_pressure,
    mask_area,
    weighted_mean,
    zonal_average,
)

DIAGNOSTICS_REGISTRY = Registry()
METRICS_REGISTRY = Registry()

HISTOGRAM_BINS = {
    "total_precipitation_rate": np.concatenate(
        [[0.0], 10 ** np.linspace(-2, 2.3, 50)]
    )
    / 86400.0,  # mm/day -> kg/m2/s-ish scale left to callers
}
_MASK_TYPES = ["global", "land", "sea", "tropics"]


def _vars_2d(run: Mapping) -> Dict[str, np.ndarray]:
    return {k: v for k, v in run.items() if np.ndim(v) == 4}


def _vars_3d(run: Mapping) -> Dict[str, np.ndarray]:
    return {k: v for k, v in run.items() if np.ndim(v) == 5}


# ----------------------------------------------------------------------
# 2D groups
# ----------------------------------------------------------------------


@DIAGNOSTICS_REGISTRY.register("rms_global")
def rms_global(arg: DiagArg) -> Dict:
    """RMSE vs verification per time (compute.py:198)."""
    out = {}
    area = mask_area("global", arg.grid)
    for name, arr in _vars_2d(arg.prediction).items():
        if name in arg.verification:
            nt = min(arr.shape[0], arg.verification[name].shape[0])
            err = arr[:nt] - arg.verification[name][:nt]
            out[name] = np.sqrt(
                weighted_mean(err ** 2, area[None], (1, 2, 3))
            )
    return out


@DIAGNOSTICS_REGISTRY.register("global_mean_timeseries")
def global_mean_timeseries(arg: DiagArg) -> Dict:
    area = mask_area("global", arg.grid)
    return {
        name: weighted_mean(arr, area[None], (1, 2, 3))
        for name, arr in _vars_2d(arg.prediction).items()
    }


@DIAGNOSTICS_REGISTRY.register("time_mean_value")
def time_mean_value(arg: DiagArg) -> Dict:
    """Time-mean maps (compute.py:435)."""
    return {
        name: arr.mean(axis=0)
        for name, arr in _vars_2d(arg.prediction).items()
    }


@DIAGNOSTICS_REGISTRY.register("time_mean_bias")
def time_mean_bias(arg: DiagArg) -> Dict:
    """Time-mean bias maps vs verification (compute.py:444)."""
    out = {}
    for name, arr in _vars_2d(arg.prediction).items():
        if name in arg.verification:
            nt = min(arr.shape[0], arg.verification[name].shape[0])
            out[name] = (
                arr[:nt] - arg.verification[name][:nt]
            ).mean(axis=0)
    return out


@DIAGNOSTICS_REGISTRY.register("zonal_and_time_mean")
def zonal_and_time_mean(arg: DiagArg) -> Dict:
    """(compute.py:214)"""
    out = {}
    for name, arr in _vars_2d(arg.prediction).items():
        lat, prof = zonal_average(
            arr.mean(axis=0), arg.grid["lat"], arg.grid["area"]
        )
        out[name] = prof
        out.setdefault("latitude", lat)
    return out


@DIAGNOSTICS_REGISTRY.register("zonal_mean_value")
def zonal_mean_value(arg: DiagArg) -> Dict:
    """Hovmoller [time, lat] (compute.py:299)."""
    out = {}
    for name, arr in _vars_2d(arg.prediction).items():
        _, prof = zonal_average(
            arr, arg.grid["lat"], arg.grid["area"]
        )
        out[name] = prof
    return out


@DIAGNOSTICS_REGISTRY.register("zonal_mean_bias")
def zonal_mean_bias(arg: DiagArg) -> Dict:
    """(compute.py:316)"""
    out = {}
    for name, arr in _vars_2d(arg.prediction).items():
        if name in arg.verification:
            nt = min(arr.shape[0], arg.verification[name].shape[0])
            _, prof = zonal_average(
                arr[:nt] - arg.verification[name][:nt],
                arg.grid["lat"], arg.grid["area"],
            )
            out[name] = prof
    return out


@DIAGNOSTICS_REGISTRY.register("deep_tropical_meridional_mean_value")
def deep_tropical_meridional_mean(arg: DiagArg) -> Dict:
    """Mean over |lat|<=10 per time (compute.py:357)."""
    area = mask_area("tropics", arg.grid)
    return {
        name: weighted_mean(arr, area[None], (1, 2, 3))
        for name, arr in _vars_2d(arg.prediction).items()
    }


def _register_masked_reductions():
    for mask_type in _MASK_TYPES:

        @DIAGNOSTICS_REGISTRY.register(f"spatial_mean_{mask_type}")
        def spatial_mean(arg: DiagArg, mask_type=mask_type) -> Dict:
            """(compute.py:408)"""
            area = mask_area(mask_type, arg.grid)
            return {
                name: weighted_mean(arr, area[None], (1, 2, 3))
                for name, arr in _vars_2d(arg.prediction).items()
            }

        @DIAGNOSTICS_REGISTRY.register(f"spatial_min_{mask_type}")
        def spatial_min(arg: DiagArg, mask_type=mask_type) -> Dict:
            """(compute.py:381)"""
            area = mask_area(mask_type, arg.grid)
            sel = area > 0
            return {
                name: arr[:, sel].min(axis=1)
                for name, arr in _vars_2d(arg.prediction).items()
                if sel.any()
            }

        @DIAGNOSTICS_REGISTRY.register(f"spatial_max_{mask_type}")
        def spatial_max(arg: DiagArg, mask_type=mask_type) -> Dict:
            """(compute.py:393)"""
            area = mask_area(mask_type, arg.grid)
            sel = area > 0
            return {
                name: arr[:, sel].max(axis=1)
                for name, arr in _vars_2d(arg.prediction).items()
                if sel.any()
            }

        @DIAGNOSTICS_REGISTRY.register(f"mean_bias_{mask_type}")
        def mean_bias(arg: DiagArg, mask_type=mask_type) -> Dict:
            """(compute.py:418)"""
            area = mask_area(mask_type, arg.grid)
            out = {}
            for name, arr in _vars_2d(arg.prediction).items():
                if name in arg.verification:
                    nt = min(
                        arr.shape[0], arg.verification[name].shape[0]
                    )
                    err = arr[:nt] - arg.verification[name][:nt]
                    out[name] = weighted_mean(
                        err, area[None], (1, 2, 3)
                    )
            return out


_register_masked_reductions()


def _register_diurnal():
    for mask_type in ["land", "sea"]:

        @DIAGNOSTICS_REGISTRY.register(f"diurnal_{mask_type}")
        def diurnal(arg: DiagArg, mask_type=mask_type) -> Dict:
            """Local-solar-time diurnal composites (compute.py:455)."""
            area = mask_area(mask_type, arg.grid)
            if not (area > 0).any():
                return {}
            dt_hours = float(arg.grid.get("dt_hours", 3.0))
            t0_hour = float(arg.grid.get("t0_hour", 0.0))
            return {
                name: diurnal_cycle(
                    arr, arg.grid["lon"], area, dt_hours,
                    t0_hour=t0_hour,
                )
                for name, arr in _vars_2d(arg.prediction).items()
            }


_register_diurnal()


@DIAGNOSTICS_REGISTRY.register("histogram")
def histogram_group(arg: DiagArg) -> Dict:
    """Area-weighted distributions (compute.py:476)."""
    out = {}
    for name, arr in _vars_2d(arg.prediction).items():
        lo, hi = np.nanmin(arr), np.nanmax(arr)
        if not np.isfinite([lo, hi]).all() or lo == hi:
            continue
        bins = HISTOGRAM_BINS.get(
            name, np.linspace(lo, hi, 51)
        )
        counts, edges = histogram(arr, arg.grid["area"], bins)
        out[name] = counts
        out[name + "_bins"] = edges
    return out


@DIAGNOSTICS_REGISTRY.register("hist_bias")
def hist_bias(arg: DiagArg) -> Dict:
    """Histogram difference vs verification (compute.py:494)."""
    out = {}
    for name, arr in _vars_2d(arg.prediction).items():
        if name not in arg.verification:
            continue
        ver = arg.verification[name]
        lo = min(np.nanmin(arr), np.nanmin(ver))
        hi = max(np.nanmax(arr), np.nanmax(ver))
        if not np.isfinite([lo, hi]).all() or lo == hi:
            continue
        bins = np.linspace(lo, hi, 51)
        c1, _ = histogram(arr, arg.grid["area"], bins)
        c2, _ = histogram(ver, arg.grid["area"], bins)
        out[name] = c1 - c2
    return out


# ----------------------------------------------------------------------
# 3D groups
# ----------------------------------------------------------------------


def _delp(arg: DiagArg):
    d = arg.grid.get("delp")
    return None if d is None else np.asarray(d)


@DIAGNOSTICS_REGISTRY.register("pressure_level_zonal_time_mean")
def pressure_level_zonal_time_mean(arg: DiagArg) -> Dict:
    """Zonal-pressure sections (compute.py:226)."""
    delp = _delp(arg)
    if delp is None:
        return {}
    out = {}
    for name, arr in _vars_3d(arg.prediction).items():
        onp = interpolate_to_pressure(
            arr.mean(axis=0), delp.mean(axis=0), device=arg.device
        )  # [tile, p, y, x]
        _, prof = zonal_average(
            np.moveaxis(onp, 1, 0), arg.grid["lat"], arg.grid["area"]
        )  # [p, nbins]
        out[name] = prof
    return out


@DIAGNOSTICS_REGISTRY.register("pressure_level_zonal_bias")
def pressure_level_zonal_bias(arg: DiagArg) -> Dict:
    """(compute.py:245)"""
    delp = _delp(arg)
    if delp is None:
        return {}
    out = {}
    for name, arr in _vars_3d(arg.prediction).items():
        if name not in arg.verification:
            continue
        nt = min(arr.shape[0], arg.verification[name].shape[0])
        bias = arr[:nt].mean(axis=0) - arg.verification[name][
            :nt
        ].mean(axis=0)
        onp = interpolate_to_pressure(bias, delp[:nt].mean(axis=0),
                                      device=arg.device)
        _, prof = zonal_average(
            np.moveaxis(onp, 1, 0), arg.grid["lat"], arg.grid["area"]
        )
        out[name] = prof
    return out


@DIAGNOSTICS_REGISTRY.register("300_700_zonal_mean_value")
def zonal_mean_300_700(arg: DiagArg) -> Dict:
    """Mass-weighted 300-700 hPa mean, then zonal profile per time
    (compute.py:538)."""
    delp = _delp(arg)
    if delp is None:
        return {}
    out = {}
    levels = 100.0 * np.array([300.0, 500.0, 700.0])
    for name, arr in _vars_3d(arg.prediction).items():
        onp = np.stack(
            [
                interpolate_to_pressure(
                    arr[t], delp[min(t, delp.shape[0] - 1)],
                    levels=levels, device=arg.device,
                )
                for t in range(arr.shape[0])
            ]
        ).mean(axis=2)  # [time, tile, y, x]
        _, prof = zonal_average(
            onp, arg.grid["lat"], arg.grid["area"]
        )
        out[name] = prof
    return out


@DIAGNOSTICS_REGISTRY.register("column_integrated_mean")
def column_integrated_mean(arg: DiagArg) -> Dict:
    """Mass-weighted column means of 3D fields -> global time series
    (the reference's column_integrated_vars pathway)."""
    delp = _delp(arg)
    if delp is None:
        return {}
    area = mask_area("global", arg.grid)
    out = {}
    for name, arr in _vars_3d(arg.prediction).items():
        nt = min(arr.shape[0], delp.shape[0])
        col = (arr[:nt] * delp[:nt]).sum(axis=2) / delp[:nt].sum(
            axis=2
        )
        out[name] = weighted_mean(col, area[None], (1, 2, 3))
    return out


# ----------------------------------------------------------------------
# budgets
# ----------------------------------------------------------------------


@DIAGNOSTICS_REGISTRY.register("water_budget")
def water_budget(arg: DiagArg) -> Dict:
    """Global water budget residual: d<TWP>/dt vs (E - P)
    (the reference's water budget diagnostics in
    diagnostics/prognostic_run/views/static_report.py)."""
    run = arg.prediction
    need = "total_water_path"
    if need not in run:
        return {}
    area = mask_area("global", arg.grid)
    twp = weighted_mean(run[need], area[None], (1, 2, 3))
    dt_s = float(arg.grid.get("dt_hours", 3.0)) * 3600.0
    storage = np.gradient(twp, dt_s) if len(twp) > 1 else twp * 0
    out = {"storage_of_total_water_path": storage}
    evap = run.get("evaporation")
    precip = run.get("total_precipitation_rate")
    if evap is not None and precip is not None:
        e = weighted_mean(evap, area[None], (1, 2, 3))
        p = weighted_mean(precip, area[None], (1, 2, 3))
        out["evaporation_minus_precipitation"] = e - p
        n = min(len(storage), len(e))
        out["water_budget_residual"] = storage[:n] - (e - p)[:n]
    return out


@DIAGNOSTICS_REGISTRY.register("energy_budget")
def energy_budget(arg: DiagArg) -> Dict:
    """Global TOA/surface net-flux imbalance time series."""
    run = arg.prediction
    area = mask_area("global", arg.grid)
    out = {}
    toa_terms = {
        "shortwave_in": run.get(
            "total_sky_downward_shortwave_flux_at_top_of_atmosphere"
        ),
        "shortwave_out": run.get(
            "total_sky_upward_shortwave_flux_at_top_of_atmosphere"
        ),
        "longwave_out": run.get(
            "total_sky_upward_longwave_flux_at_top_of_atmosphere"
        ),
    }
    if all(v is not None for v in toa_terms.values()):
        net = (
            toa_terms["shortwave_in"]
            - toa_terms["shortwave_out"]
            - toa_terms["longwave_out"]
        )
        out["net_energy_flux_toa"] = weighted_mean(
            net, area[None], (1, 2, 3)
        )
    if "column_heating" in run:
        out["column_heating_global"] = weighted_mean(
            run["column_heating"], area[None], (1, 2, 3)
        )
    return out


def load_run(path: str) -> Dict[str, np.ndarray]:
    """Read all arrays of a run's diagnostics store (host arrays: the
    interpolation's device is compute_diagnostics')."""
    from ..io.zarr_lite import ZarrLiteStore

    store = ZarrLiteStore(path)
    return {name: store.read(name) for name in store.arrays()}


def compute_diagnostics(
    run, area=None, lat=None, lon=None, verification=None, grid=None,
    workers: int = 1, device=None,
):
    """The `prognostic_run_diags compute` entry (prognostic_run/cli.py:16).

    ``run`` may be a path to a zarr-lite store or an array dict.
    Returns (diagnostics, metrics): metrics come from the metrics
    registry applied to the computed diagnostics (metrics.py pattern).
    The pressure-level interpolation runs on `device`: the CUDA device
    unless the caller names another (``device="cpu"``).
    """
    device = (torch.device(device) if device is not None
              else default_device("compute_diagnostics"))
    if isinstance(run, str):
        run = load_run(run)
        run.pop("time", None)
    if grid is None:
        grid = {"area": area, "lat": lat}
        if lon is not None:
            grid["lon"] = lon
    arg = DiagArg(dict(run), dict(verification or {}), dict(grid), device)
    diags = DIAGNOSTICS_REGISTRY.compute(arg, workers=workers)
    from .metrics import compute_metrics

    metrics = compute_metrics(diags, arg)
    return diags, metrics
