"""Diagnostic line plots (fv3viz/_plot_diagnostics.py:
plot_diurnal_cycle, plot_time_series)."""

from __future__ import annotations

import numpy as np


def plot_diurnal_cycle(
    local_time_hr,
    values,
    ax=None,
    label=None,
    n_bins: int = 24,
    **kwargs,
):
    """Bin values by local solar hour and plot the mean cycle
    (fv3viz plot_diurnal_cycle semantics).  Returns (ax, bin_means)."""
    import matplotlib.pyplot as plt

    if ax is None:
        ax = plt.gca()
    t = np.asarray(local_time_hr).ravel() % 24.0
    v = np.asarray(values).ravel()
    ok = np.isfinite(t) & np.isfinite(v)
    edges = np.linspace(0, 24, n_bins + 1)
    idx = np.clip(np.digitize(t[ok], edges) - 1, 0, n_bins - 1)
    sums = np.bincount(idx, weights=v[ok], minlength=n_bins)
    counts = np.bincount(idx, minlength=n_bins)
    means = sums / np.maximum(counts, 1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    ax.plot(centers, means, label=label, **kwargs)
    ax.set_xlabel("local time [hr]")
    ax.set_xlim(0, 24)
    if label:
        ax.legend()
    return ax, means


def plot_time_series(times, values, ax=None, label=None, **kwargs):
    """(fv3viz plot_time_series): values [t] or [t, ...] averaged over
    trailing dims."""
    import matplotlib.pyplot as plt

    if ax is None:
        ax = plt.gca()
    v = np.asarray(values)
    if v.ndim > 1:
        v = v.reshape(v.shape[0], -1).mean(axis=1)
    ax.plot(np.asarray(times), v, label=label, **kwargs)
    if label:
        ax.legend()
    return ax
