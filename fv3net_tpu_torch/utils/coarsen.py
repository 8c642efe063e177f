"""Cubed-sphere block coarsening (vcm/cubedsphere/coarsen.py; the JAX
package's ``utils/coarsen.py``).

The reference's coarsening engine reduces C3072/C384 output to C48
training resolution with dask-parallel block reductions
(coarsen.py:183-900).  Here they are reshape-reduce tensor operations:
the functions below operate on the trailing (y, x) axes of a host array
(numpy, on the host) or a tensor (torch, on its device) and keep the
reference semantics: weighted averages for cell quantities,
edge-weighted averages for staggered winds, sums for fluxes, medians /
modes for surface categories, and upsampling.  ``block_mode`` is host
code for either (a tensor is read to the host), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def to_host(a):
    """A host array of `a` (a tensor is read from its device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _block_view(a, factor):
    """[..., y, x] -> [..., y/f, f, x/f, f]"""
    *lead, ny, nx = a.shape
    if ny % factor or nx % factor:
        raise ValueError(
            f"cannot coarsen shape {tuple(a.shape)} by factor {factor}"
        )
    return a.reshape(*lead, ny // factor, factor, nx // factor, factor)


def _reduce(v, method, dims):
    if isinstance(v, torch.Tensor):
        if method in ("min", "max"):
            fn = torch.amin if method == "min" else torch.amax
            return fn(v, dim=dims)
        return getattr(v, method)(dim=dims)
    return getattr(v, method)(axis=dims)


def block_coarsen(a, factor: int, method: str = "mean"):
    """(coarsen.py:795): reduce factor x factor blocks."""
    v = _block_view(a, factor)
    if method in ("mean", "sum", "min", "max"):
        return _reduce(v, method, (-3, -1))
    if method == "median":
        return block_median(a, factor)
    raise ValueError(f"unknown method {method}")


def weighted_block_average(a, weights, factor: int):
    """(coarsen.py:183): e.g. area-weighted field coarsening."""
    va = _block_view(a * weights, factor)
    if isinstance(a, torch.Tensor):
        w = torch.broadcast_to(torch.as_tensor(weights), a.shape)
    else:
        w = np.broadcast_to(weights, a.shape)
    vw = _block_view(w, factor)
    return _reduce(va, "sum", (-3, -1)) / _reduce(vw, "sum", (-3, -1))


def edge_weighted_block_average(a, spacing, factor: int, axis: int):
    """(coarsen.py:221): coarsen staggered edge data: length-weighted
    mean along the edge direction, subsample across it.

    axis: -1 to reduce along x (data staggered in y), -2 along y.
    """
    w = a * spacing
    if axis == -1:
        *lead, ny, nx = a.shape
        wv = w.reshape(*lead, ny, nx // factor, factor)
        sv = spacing.reshape(
            *spacing.shape[:-2], ny, nx // factor, factor
        )
        avg = wv.sum(-1) / sv.sum(-1)
        return avg[..., ::factor, :]
    if axis == -2:
        *lead, ny, nx = a.shape
        wv = w.reshape(*lead, ny // factor, factor, nx)
        sv = spacing.reshape(
            *spacing.shape[:-2], ny // factor, factor, nx
        )
        avg = wv.sum(-2) / sv.sum(-2)
        return avg[..., :, ::factor]
    raise ValueError(axis)


def block_edge_sum(a, factor: int, axis: int):
    """(coarsen.py:591): sum staggered edge data within blocks along the
    edge, subsampling across."""
    if axis == -1:
        *lead, ny, nx = a.shape
        s = a.reshape(*lead, ny, nx // factor, factor).sum(-1)
        return s[..., ::factor, :]
    if axis == -2:
        *lead, ny, nx = a.shape
        s = a.reshape(*lead, ny // factor, factor, nx).sum(-2)
        return s[..., :, ::factor]
    raise ValueError(axis)


def block_median(a, factor: int):
    """(coarsen.py:557): the median of each block, the mean of the two
    middle values of an even count (numpy's median)."""
    v = _block_view(a, factor)
    *lead, nyc, f1, nxc, f2 = v.shape
    flat = v.swapaxes(-3, -2).reshape(*lead, nyc, nxc, f1 * f2)
    if not isinstance(a, torch.Tensor):
        return np.median(flat, axis=-1)
    s = torch.sort(flat, dim=-1).values
    k = f1 * f2 // 2
    if (f1 * f2) % 2:
        return s[..., k]
    return 0.5 * (s[..., k - 1] + s[..., k])


def block_mode(a, factor: int):
    """(coarsen.py:750): most common value per block (for categorical
    surface fields); host code, returns a host array."""
    a = to_host(a)
    v = _block_view(a, factor)
    *lead, nyc, f1, nxc, f2 = v.shape
    flat = v.swapaxes(-3, -2).reshape(*lead, nyc, nxc, f1 * f2)
    out = np.empty(flat.shape[:-1], dtype=a.dtype)
    it = np.ndindex(*flat.shape[:-1])
    for idx in it:
        vals, counts = np.unique(flat[idx], return_counts=True)
        out[idx] = vals[np.argmax(counts)]
    return out


def block_upsample(a, factor: int):
    """(coarsen.py:869): nearest-neighbor upsampling."""
    if isinstance(a, torch.Tensor):
        return torch.repeat_interleave(
            torch.repeat_interleave(a, factor, dim=-2), factor, dim=-1
        )
    return np.repeat(np.repeat(a, factor, axis=-2), factor, axis=-1)


def xarray_block_reduce(a, factor: int, reduction: str = "mean"):
    """compat name (coarsen.py:463)"""
    return block_coarsen(a, factor, reduction)


def horizontal_block_reduce(a, factor: int, reduction: str = "mean"):
    """compat name (coarsen.py:520)"""
    return block_coarsen(a, factor, reduction)
