"""Scalar skill metrics + histograms (vcm/calc/metrics.py,
vcm/calc/histogram.py, vcm/select.py zonal_average_approximate; the JAX
package's ``utils/metrics.py``).

The skill scores accept host arrays or tensors and an optional `weights`
array (area weighting is the reference's default for global skill
scores); reductions happen on whatever device the input lives on (a
tensor's score is a 0-d tensor there).  The histograms and the zonal
average are host numpy (a tensor is read to the host), as in the JAX
package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .coarsen import to_host


def _xp(a):
    return torch if isinstance(a, torch.Tensor) else np


def _f32(x):
    """A boolean field as float32 (0/1)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return x.astype(np.float32)


def _wmean(x, w, xp):
    if w is None:
        return xp.mean(x)
    return xp.sum(x * w) / xp.sum(w)


def mean_squared_error(truth, pred, weights=None):
    xp = _xp(truth)
    return _wmean((truth - pred) ** 2, weights, xp)


def root_mean_squared_error(truth, pred, weights=None):
    xp = _xp(truth)
    return xp.sqrt(mean_squared_error(truth, pred, weights))


def bias(truth, pred, weights=None):
    xp = _xp(truth)
    return _wmean(pred - truth, weights, xp)


def mean_absolute_error(truth, pred, weights=None):
    xp = _xp(truth)
    return _wmean(xp.abs(pred - truth), weights, xp)


def r2_score(truth, pred, weights=None):
    """(vcm/calc/metrics.py): 1 - MSE / Var(truth), weighted."""
    xp = _xp(truth)
    mse = mean_squared_error(truth, pred, weights)
    tmean = _wmean(truth, weights, xp)
    var = _wmean((truth - tmean) ** 2, weights, xp)
    return 1.0 - mse / var


def accuracy(truth, pred, mean_dims_weights=None):
    xp = _xp(truth)
    return _wmean(
        _f32(truth == pred), mean_dims_weights, xp
    )


def precision(truth, pred, weights=None):
    """Of predicted positives, the fraction truly positive (boolean
    fields)."""
    xp = _xp(truth)
    tp = _wmean(
        _f32(truth & pred), weights, xp
    )
    pp = _wmean(_f32(pred), weights, xp)
    return tp / pp


def recall(truth, pred, weights=None):
    xp = _xp(truth)
    tp = _wmean(_f32(truth & pred), weights, xp)
    ap = _wmean(_f32(truth), weights, xp)
    return tp / ap


def f1_score(truth, pred, weights=None):
    p = precision(truth, pred, weights)
    r = recall(truth, pred, weights)
    return 2.0 * p * r / (p + r)


def false_positive_rate(truth, pred, weights=None):
    xp = _xp(truth)
    fp = _wmean(
        _f32((~truth) & pred), weights, xp
    )
    neg = _wmean(_f32(~truth), weights, xp)
    return fp / neg


def histogram(a, bins=None, weights=None,
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(vcm/calc/histogram.py): counts + bin edges; log-spaced default
    bins like the reference's precipitation histograms."""
    a = to_host(a).ravel()
    if bins is None:
        lo = np.nanpercentile(a, 1)
        hi = np.nanpercentile(a, 99)
        if lo == hi:
            hi = lo + 1.0
        bins = np.linspace(lo, hi, 51)
    w = None if weights is None else to_host(weights).ravel()
    counts, edges = np.histogram(a, bins=bins, weights=w)
    return counts, edges


def histogram2d(x, y, bins=50):
    x = to_host(x).ravel()
    y = to_host(y).ravel()
    return np.histogram2d(x, y, bins=bins)


def zonal_average_approximate(
    lat, field, bins: Optional[np.ndarray] = None,
    weights: Optional[np.ndarray] = None,
):
    """(vcm/select.py:zonal_average_approximate): bin cells by latitude
    and average within bins -- the cubed-sphere's 'zonal mean'.

    lat [6, ny, nx] in radians or degrees; field [..., 6, ny, nx] or
    [6, ..., ny, nx]; returns (bin_centers_deg, means[..., nbin]).
    """
    lat = to_host(lat)
    if np.abs(lat).max() < 4.0:  # radians
        lat = np.rad2deg(lat)
    if bins is None:
        bins = np.arange(-90.0, 91.0, 2.0)
    field = to_host(field)
    # move the horizontal dims last: assume they are the trailing
    # [6(? leading), ...]; canonical layout is [6, (z,) ny, nx] or
    # [..., 6, ny, nx] -- detect by matching lat.shape
    if field.shape[-3:] == lat.shape:
        flat = field.reshape(field.shape[:-3] + (-1,))
    elif field.shape[0] == lat.shape[0] and (
        field.shape[-2:] == lat.shape[-2:]
    ):
        # [6, ..., ny, nx] -> [..., 6*ny*nx]
        moved = np.moveaxis(field, 0, -3)
        flat = moved.reshape(moved.shape[:-3] + (-1,))
    else:
        raise ValueError(
            f"cannot align field {field.shape} with lat {lat.shape}"
        )
    latf = lat.ravel()
    w = (np.ones_like(latf) if weights is None
         else to_host(weights).ravel())
    idx = np.digitize(latf, bins) - 1
    nbin = len(bins) - 1
    out = np.full(flat.shape[:-1] + (nbin,), np.nan, np.float64)
    for b in range(nbin):
        sel = idx == b
        if sel.any():
            wsel = w[sel]
            out[..., b] = (
                (flat[..., sel] * wsel).sum(-1) / wsel.sum()
            )
    centers = 0.5 * (bins[1:] + bins[:-1])
    return centers, out


# --------------------------------------------------------------------
# DataTransform registry (vcm/data_transform.py:367)
# --------------------------------------------------------------------

DATA_TRANSFORM_REGISTRY = {}


def register_data_transform(name):
    def wrap(fn):
        DATA_TRANSFORM_REGISTRY[name] = fn
        return fn

    return wrap


def apply_data_transform(name, state, **kwargs):
    return DATA_TRANSFORM_REGISTRY[name](state, **kwargs)


@register_data_transform("Q1_from_dQ1_pQ1")
def q1_from_dq1_pq1(state):
    """(vcm data_transform: total apparent heating = ML + physics)."""
    from ..util.quantity import Quantity

    out = dict(state)
    out["Q1"] = Quantity(
        np.asarray(state["dQ1"].values)
        + np.asarray(state["pQ1"].values),
        state["dQ1"].dims, state["dQ1"].units,
    )
    return out


@register_data_transform("Q2_from_dQ2_pQ2")
def q2_from_dq2_pq2(state):
    from ..util.quantity import Quantity

    out = dict(state)
    out["Q2"] = Quantity(
        np.asarray(state["dQ2"].values)
        + np.asarray(state["pQ2"].values),
        state["dQ2"].dims, state["dQ2"].units,
    )
    return out
