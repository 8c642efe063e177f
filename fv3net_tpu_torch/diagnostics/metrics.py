"""Scalar metrics computed from diagnostics (a copy of the JAX
package's ``diagnostics/metrics.py``;
workflows/diagnostics/fv3net/diagnostics/prognostic_run/metrics.py).

The reference's metrics registry reduces the computed diagnostic
groups to named scalar metrics — rmse_Nday, drift_3day, time-and-mask
mean values/biases, rmse of the time mean, precipitation percentiles —
serialized as JSON and consumed by the report and scoreboards.  Same
shape here: each function grabs a diagnostic group by suffix
(metrics.py:30 grab_diag) and returns {metric_name: float}.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from .registry import Registry
from .transforms import DiagArg, mask_area, weighted_mean

metrics_registry = Registry()


def grab_diag(diags: Mapping, suffix: str) -> Dict[str, np.ndarray]:
    """Variables of one diagnostic group (metrics.py:30): keys look
    like '{var}_{group}'."""
    out = {}
    for key, val in diags.items():
        if key.endswith("_" + suffix):
            out[key[: -len(suffix) - 1]] = val
    return out


def _steps_per_day(arg: DiagArg) -> float:
    return 24.0 / float(arg.grid.get("dt_hours", 3.0))


def _register_rmse_days():
    for day in (3, 5, 7):

        @metrics_registry.register(f"rmse_{day}day")
        def rmse_day(diags, arg: DiagArg, day=day) -> Dict:
            """(metrics.py:93)"""
            rms = grab_diag(diags, "rms_global")
            spd = _steps_per_day(arg)
            out = {}
            for name, series in rms.items():
                i = int(day * spd)
                if np.ndim(series) == 1 and len(series) > i:
                    out[name] = float(series[i])
            return out


_register_rmse_days()


@metrics_registry.register("rmse_days_3to7_avg")
def rmse_days_3to7(diags, arg: DiagArg) -> Dict:
    """(metrics.py:109)"""
    rms = grab_diag(diags, "rms_global")
    spd = _steps_per_day(arg)
    out = {}
    for name, series in rms.items():
        i0, i1 = int(3 * spd), int(7 * spd)
        if np.ndim(series) == 1 and len(series) > i0:
            out[name] = float(
                np.asarray(series[i0 : max(i1, i0 + 1)]).mean()
            )
    return out


@metrics_registry.register("drift_3day")
def drift_3day(diags, arg: DiagArg) -> Dict:
    """Per-day drift of the global mean over the first 3 days
    (metrics.py:124)."""
    means = grab_diag(diags, "spatial_mean_global")
    spd = _steps_per_day(arg)
    out = {}
    for name, series in means.items():
        n = int(3 * spd)
        if np.ndim(series) == 1 and len(series) >= max(n, 2):
            first_day = np.asarray(series[: max(int(spd), 1)]).mean()
            third_day = np.asarray(
                series[int(2 * spd) : max(n, int(2 * spd) + 1)]
            ).mean()
            out[name] = float((third_day - first_day) / 2.0)
    return out


def _register_time_mask_means():
    for mask_type in ["global", "land", "sea", "tropics"]:

        @metrics_registry.register(
            f"time_and_{mask_type}_mean_value"
        )
        def time_mask_mean(diags, arg: DiagArg, mask_type=mask_type):
            """(metrics.py:147)"""
            maps = grab_diag(diags, "time_mean_value")
            area = mask_area(mask_type, arg.grid)
            return {
                name: float(weighted_mean(m, area, (0, 1, 2)))
                for name, m in maps.items()
                if np.ndim(m) == 3
            }

        @metrics_registry.register(f"time_and_{mask_type}_mean_bias")
        def time_mask_bias(diags, arg: DiagArg, mask_type=mask_type):
            """(metrics.py:162)"""
            maps = grab_diag(diags, "time_mean_bias")
            area = mask_area(mask_type, arg.grid)
            return {
                name: float(weighted_mean(m, area, (0, 1, 2)))
                for name, m in maps.items()
                if np.ndim(m) == 3
            }


_register_time_mask_means()


@metrics_registry.register("rmse_of_time_mean")
def rmse_of_time_mean(diags, arg: DiagArg) -> Dict:
    """(metrics.py:177)"""
    maps = grab_diag(diags, "time_mean_bias")
    area = mask_area("global", arg.grid)
    return {
        name: float(
            np.sqrt(weighted_mean(m ** 2, area, (0, 1, 2)))
        )
        for name, m in maps.items()
        if np.ndim(m) == 3
    }


def _register_percentiles():
    for pct in (25, 50, 75, 90, 99):

        @metrics_registry.register(f"percentile_{pct}")
        def percentile(diags, arg: DiagArg, pct=pct) -> Dict:
            """From the histogram group (metrics.py:192)."""
            hists = grab_diag(diags, "histogram")
            out = {}
            for name, counts in hists.items():
                if name.endswith("_bins"):
                    continue
                edges = hists.get(name + "_bins")
                if edges is None or np.ndim(counts) != 1:
                    continue
                widths = np.diff(edges)
                cdf = np.cumsum(counts * widths)
                if cdf[-1] <= 0:
                    continue
                cdf = cdf / cdf[-1]
                i = int(np.searchsorted(cdf, pct / 100.0))
                out[name] = float(edges[min(i + 1, len(edges) - 1)])
            return out


_register_percentiles()


@metrics_registry.register("tropics_max_minus_min")
def tropics_max_minus_min(diags, arg: DiagArg) -> Dict:
    """ITCZ-strength proxy from the tropical meridional profile
    (metrics.py:211)."""
    prof = grab_diag(diags, "zonal_and_time_mean")
    lat = prof.pop("latitude", None)
    if lat is None:
        return {}
    sel = np.abs(lat) <= 20.0
    out = {}
    for name, p in prof.items():
        if np.ndim(p) == 1 and len(p) == len(lat) and sel.any():
            band = p[sel]
            band = band[np.isfinite(band)]
            if band.size:
                out[name] = float(band.max() - band.min())
    return out


def compute_metrics(diags: Mapping, arg: DiagArg) -> Dict[str, float]:
    """Flat {'{metric}/{var}': float} dict (merge_metrics,
    metrics.py:79)."""
    out: Dict[str, float] = {}
    for metric_name, fn in metrics_registry.funcs.items():
        try:
            result = fn(diags, arg)
        except Exception:
            continue
        for var, val in (result or {}).items():
            if np.isfinite(val):
                out[f"{metric_name}/{var}"] = float(val)
    return out
