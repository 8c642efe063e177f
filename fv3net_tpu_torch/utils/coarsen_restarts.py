"""Restart-state coarsening (vcm/cubedsphere/coarsen_restarts.py:
coarsen_restarts_on_sigma :77, coarsen_restarts_on_pressure :152,
coarsen_restarts_via_blended_method :228, hydrostatic-balance
imposition :916, dominant-surface-type sfc_data logic :1032-1410; the
JAX package's ``utils/coarsen_restarts.py``).

This is the engine that turns C384/C3072 fine-run restarts into C48
training states.  Every operation is an array transform (block reshapes
and reductions, plus the PPM remap for the pressure-level variant) on
host arrays (numpy) or tensors (torch, on their device) -- the reference
needed a dask/Beam cluster for the same job (SURVEY L8).  The pressure
method's remap runs on a torch device for host arrays too (``device``,
the CUDA device by default), as the JAX package runs it in jnp; on CUDA
float32 tensors it is the K5 kernel (``ops.remap.remap_levels_mappm``).
The categorical block modes and the "complex" surface method are host
code (tensors are read to the host), as in the JAX package.

Field dictionaries use the framework's canonical state names; arrays
are [6, nz, ny, nx] (cell scalars), [6, nz, ny+1, nx] / [6, nz, ny,
nx+1] (D-grid winds), [6, ny, nx] (surface).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..constants import GRAV, RDGAS
from ..device import device_for
from .coarsen import (
    block_coarsen,
    block_mode,
    edge_weighted_block_average,
    to_host,
    weighted_block_average,
)


def _xp(a):
    return torch if isinstance(a, torch.Tensor) else np


def _like(a, ref):
    """`a` as a tensor on `ref`'s device where `ref` is one, else as a
    host array."""
    if isinstance(ref, torch.Tensor):
        return torch.as_tensor(a, device=ref.device)
    return to_host(a)


VERTICAL_3D = ("air_temperature", "specific_humidity",
               "cloud_water_mixing_ratio", "vertical_wind")
DELP = "pressure_thickness_of_atmospheric_layer"
DELZ = "vertical_thickness_of_atmospheric_layer"
XW, YW = "x_wind", "y_wind"
SFC_CATEGORICAL = ("slmsk", "stype", "vtype")


def mass_weighted_block_average(field, delp, area, factor: int):
    """sum(area*delp*x) / sum(area*delp) over factor x factor blocks
    (coarsen_restarts.py:316): the mass-consistent scalar coarsening."""
    w = delp * area[:, None]
    return weighted_block_average(field, w, factor)


def coarsen_restarts_on_sigma(
    state: Mapping[str, "np.ndarray"],
    area: "np.ndarray",
    factor: int,
    dx_edge: Optional["np.ndarray"] = None,
    dy_edge: Optional["np.ndarray"] = None,
) -> Dict[str, "np.ndarray"]:
    """Model-level (sigma-like) coarsening (coarsen_restarts.py:77):
    delp by area-weighted mean, scalars mass-weighted, D-grid winds
    edge-length weighted on their own staggering, surface fields
    area-weighted (categorical fields by block mode)."""
    out: Dict[str, np.ndarray] = {}
    delp = state[DELP]
    delp_c = weighted_block_average(delp, _bcast3(area, delp), factor)
    out[DELP] = delp_c
    for name, f in state.items():
        if name == DELP:
            continue
        if name == XW:  # [6, nz, ny+1, nx]: average along x edges
            w = dx_edge if dx_edge is not None else _ones_like(
                f, axis=-1
            )
            out[name] = edge_weighted_block_average(
                f, w, factor, axis=-1
            )
        elif name == YW:  # [6, nz, ny, nx+1]
            w = dy_edge if dy_edge is not None else _ones_like(
                f, axis=-2
            )
            out[name] = edge_weighted_block_average(
                f, w, factor, axis=-2
            )
        elif f.ndim == delp.ndim and f.shape == delp.shape:
            out[name] = mass_weighted_block_average(
                f, delp, area, factor
            )
        elif f.ndim == delp.ndim - 1:  # surface field
            if name in SFC_CATEGORICAL:
                out[name] = block_mode(f, factor)
            else:
                out[name] = weighted_block_average(f, area, factor)
        else:
            out[name] = block_coarsen(f, factor, "mean")
    return out


def _bcast3(area, ref):
    return area[:, None] if ref.ndim == 4 else area


def _ones_like(f, axis):
    if isinstance(f, torch.Tensor):
        return torch.ones_like(f)
    return np.ones(list(f.shape), f.dtype)


def _interface_pressure(delp, ptop: float):
    """ptop + the running sum of delp over the levels (axis 1).  A
    tensor's sum is accumulated in float64 and rounded once to delp's
    dtype: torch's float32 cumsum on an H100 rounds C384's interfaces
    ~6x farther from the exact sum than the CPU's sequential one (0.035
    against 0.006 Pa at 1e5 Pa), and every target edge of the pressure
    method's remap moves with them."""
    if isinstance(delp, torch.Tensor):
        zero = torch.zeros_like(delp[:, :1], dtype=torch.float64)
        pe = torch.cat(
            [zero, torch.cumsum(delp, dim=1, dtype=torch.float64)], dim=1)
        return (ptop + pe).to(delp.dtype)
    zero = np.zeros_like(delp[:, :1])
    return ptop + np.concatenate(
        [zero, np.cumsum(delp, axis=1)], axis=1
    )


def coarsen_restarts_on_pressure(
    state: Mapping[str, "np.ndarray"],
    area: "np.ndarray",
    factor: int,
    ptop: float = 300.0,
    kord: int = 9,
    device=None,
    **edge_kwargs,
) -> Dict[str, "np.ndarray"]:
    """Pressure-level coarsening (coarsen_restarts.py:152): first remap
    every fine column onto the BLOCK-MEAN pressure coordinate (the
    coarse cell's interfaces, upsampled back to the fine grid), then
    mass-weight-average on matching levels.  This avoids mixing air
    from different pressures where terrain varies inside a block.

    The remap (mappm's rules, ``ops.remap.remap_levels_mappm``: K5 on
    CUDA float32 tensors) runs on the tensors' device, or for host
    arrays on `device` (the CUDA device unless the caller names another),
    whose results come back to the host."""
    from ..ops.remap import remap_levels_mappm
    from .coarsen import block_upsample

    delp = state[DELP]
    area3 = _bcast3(area, delp)
    delp_c = weighted_block_average(delp, area3, factor)
    # target interfaces on the fine grid = upsampled coarse interfaces
    delp_target = block_upsample(delp_c, factor)
    pe1 = _interface_pressure(delp, ptop)
    pe2 = _interface_pressure(delp_target, ptop)
    host = not isinstance(delp, torch.Tensor)
    dev = device_for([delp], device, "coarsen_restarts_on_pressure")
    p1, p2 = (torch.as_tensor(p, device=dev) for p in (pe1, pe2))

    def remap(f):
        # on the native layout [6, nz, ny, nx]
        if host:
            return remap_levels_mappm(
                torch.as_tensor(f, device=dev), p1, p2, 1, kord
            ).cpu().numpy()
        return remap_levels_mappm(f, p1, p2, 1, kord)

    remapped = {DELP: delp}
    for name, f in state.items():
        if name == DELP:
            continue
        if f.ndim == 4 and f.shape == delp.shape:
            remapped[name] = remap(f)
        else:
            remapped[name] = f
    out = coarsen_restarts_on_sigma(
        remapped, area, factor, **edge_kwargs
    )
    out[DELP] = delp_c
    return out


def impose_hydrostatic_balance(
    temp, sphum, delp, ptop: float = 300.0
):
    """delz from the hydrostatic relation (coarsen_restarts.py:916):
    dz = -Rd * Tv / g * dln(p)."""
    xp = _xp(delp)
    zvir = 461.5 / RDGAS - 1.0
    pe = _interface_pressure(delp, ptop)
    tv = temp * (1.0 + zvir * sphum)
    return -RDGAS * tv / GRAV * xp.log(pe[:, 1:] / pe[:, :-1])


def blending_weight(phis, area, factor: int):
    """Terrain-roughness blend weight per coarse cell
    (coarsen_restarts.py:539): 1 (use pressure-level method) where the
    sub-block surface geopotential is smooth, -> 0 (sigma method) over
    rough terrain."""
    mean = weighted_block_average(phis, area, factor)
    from .coarsen import block_upsample

    dev = (phis - block_upsample(mean, factor)) ** 2
    var = weighted_block_average(dev, area, factor)
    if isinstance(var, torch.Tensor):
        std = torch.sqrt(var) / GRAV  # meters
        return torch.clamp(1.0 - std / 200.0, 0.0, 1.0)
    std = np.sqrt(var) / GRAV  # meters
    return np.clip(1.0 - std / 200.0, 0.0, 1.0)


def coarsen_restarts_via_blended_method(
    state: Mapping[str, "np.ndarray"],
    area: "np.ndarray",
    factor: int,
    phis: Optional["np.ndarray"] = None,
    ptop: float = 300.0,
    device=None,
    **edge_kwargs,
) -> Dict[str, "np.ndarray"]:
    """(coarsen_restarts.py:228): pressure-level coarsening over smooth
    terrain blended with sigma-level coarsening over rough terrain (the
    pressure method's remap on `device` for host arrays, see
    ``coarsen_restarts_on_pressure``)."""
    on_sigma = coarsen_restarts_on_sigma(
        state, area, factor, **edge_kwargs
    )
    on_pres = coarsen_restarts_on_pressure(
        state, area, factor, ptop=ptop, device=device, **edge_kwargs
    )
    weight = (
        None if phis is None else blending_weight(phis, area, factor)
    )
    out = {}
    for name in on_sigma:
        a, b = on_sigma[name], on_pres[name]
        if weight is None:
            out[name] = 0.5 * (a + b)
        else:
            w = _like(weight, a)  # the blocks' mode is a host array
            if a.ndim == 4 and a.shape[-2:] == w.shape[-2:]:
                w = w[:, None]
                out[name] = (1.0 - w) * a + w * b
            elif a.shape[-2:] == weight.shape[-2:]:
                out[name] = (1.0 - w) * a + w * b
            else:  # staggered winds: identical in both methods
                out[name] = a
    return out


def coarsen_sfc_data(
    sfc: Mapping[str, "np.ndarray"], area: "np.ndarray", factor: int
) -> Dict[str, "np.ndarray"]:
    """Surface-data coarsening with dominant-surface-type masking
    (coarsen_restarts.py:1032-1410): the land/sea/ice mask coarsens by
    block mode; continuous fields average only over fine cells whose
    type matches the coarse cell's dominant type."""
    out: Dict[str, np.ndarray] = {}
    if "slmsk" in sfc:
        dominant = block_mode(sfc["slmsk"], factor)
        from .coarsen import block_upsample

        dom_fine = _like(block_upsample(dominant, factor), sfc["slmsk"])
        match = sfc["slmsk"] == dom_fine
        w = area * (match.to(area.dtype) if isinstance(match, torch.Tensor)
                    else match.astype(area.dtype))
        out["slmsk"] = dominant
    else:
        w = area
    for name, f in sfc.items():
        if name == "slmsk":
            continue
        if name in SFC_CATEGORICAL:
            out[name] = block_mode(f, factor)
        else:
            out[name] = weighted_block_average(f, w, factor)
    return out


# ----------------------------------------------------------------------
# "complex" sfc_data method + surface_chgres corrections
# (coarsen_restarts.py:1032-1411)
# ----------------------------------------------------------------------

FREEZING_TEMPERATURE = 273.16
SHDMIN_THRESHOLD = 0.011
STYPE_LAND_ICE = 16.0
VTYPE_LAND_ICE = 15.0


def _masked_mode(f, mask, factor: int):
    """Block mode over masked cells only (block_coarsen method='mode',
    nan_policy='omit'); falls back to the unmasked mode for blocks with
    no masked cell."""
    f = to_host(f).astype(np.float64)
    sel = np.where(mask, f, np.nan)
    from .coarsen import _block_view

    v = _block_view(sel, factor)
    *lead, nyc, f1, nxc, f2 = v.shape
    flat = v.swapaxes(-3, -2).reshape(*lead, nyc, nxc, f1 * f2)
    out = np.empty(flat.shape[:-1], f.dtype)
    fallback = block_mode(f, factor)
    for idx in np.ndindex(*flat.shape[:-1]):
        vals = flat[idx]
        vals = vals[np.isfinite(vals)]
        if vals.size == 0:
            out[idx] = fallback[idx]
            continue
        u, c = np.unique(vals, return_counts=True)
        out[idx] = u[np.argmax(c)]
    return out


def _masked_wavg(f, w, mask, factor: int, fallback=None):
    """Weighted block average over masked cells; blocks with zero
    masked weight take ``fallback`` (or 0)."""
    wm = np.where(mask, w, 0.0)
    num = block_coarsen(np.asarray(f, np.float64) * wm, factor,
                        method="sum")
    den = block_coarsen(wm, factor, method="sum")
    safe = np.where(den > 0, den, 1.0)
    out = num / safe
    if fallback is None:
        fallback = np.zeros_like(out)
    return np.where(den > 0, out, fallback)


def _masked_reduce(f, mask, factor: int, method: str):
    big = {"min": np.inf, "max": -np.inf}[method]
    sel = np.where(mask, np.asarray(f, np.float64), big)
    out = block_coarsen(sel, factor, method=method)
    return np.where(np.isfinite(out), out, 0.0)


def coarsen_sfc_data_complex(
    sfc: Mapping[str, "np.ndarray"], area: "np.ndarray", factor: int
) -> Dict[str, "np.ndarray"]:
    """The reference's 'complicated' Noah-LSM-aware sfc_data coarsening
    (_coarse_grain_sfc_data_complex, coarsen_restarts.py:1032):

    1. slmsk coarsens by block mode; vtype/stype by mode over cells of
       the dominant surface type.
    2. every other variable follows the per-variable method table
       (SFC_DATA_COARSENING_METHOD, :1319): plain area weights, area
       weights restricted to the dominant surface/vegetation/soil
       type, snow-/ice-fraction weighting, min/max/mode rules, and the
       tisfc sea-ice special case.
    3. surface_chgres corrections (:1355-1410): freezing clip over
       land ice, ice soil type under ice vegetation, zero canopy water
       over bare land, zero shdmin over land ice.
    """
    from .coarsen import block_upsample

    sfc = {k: to_host(v) for k, v in sfc.items()}
    area = to_host(area).astype(np.float64)
    slmsk = sfc["slmsk"]
    coarse_slmsk = block_mode(slmsk, factor)
    dom_sfc = np.isclose(slmsk, block_upsample(coarse_slmsk, factor))

    out: Dict[str, np.ndarray] = {"slmsk": coarse_slmsk}
    if "vtype" in sfc:
        out["vtype"] = _masked_mode(sfc["vtype"], dom_sfc, factor)
        dom_vtype = dom_sfc & np.isclose(
            sfc["vtype"], block_upsample(out["vtype"], factor)
        )
    else:
        dom_vtype = dom_sfc
    if "stype" in sfc:
        out["stype"] = _masked_mode(sfc["stype"], dom_sfc, factor)
        dom_stype = dom_sfc & np.isclose(
            sfc["stype"], block_upsample(out["stype"], factor)
        )
    else:
        dom_stype = dom_sfc

    vfrac = sfc.get("vfrac", np.ones_like(area))
    sncovr = sfc.get("sncovr", np.ones_like(area))
    fice = sfc.get("fice", np.ones_like(area))
    true_mask = np.ones_like(area, bool)

    plain = {
        "tsea", "alvsf", "alvwf", "alnsf", "alnwf", "facsf", "facwf",
        "f10m", "t2m", "q2m", "uustar", "ffmm", "ffhh", "tprcp",
        "snwdph",
    }
    over_dom = {"tg3", "vfrac", "fice", "sncovr"}
    vfrac_weighted = {"canopy", "zorl"}
    soil = {"smc", "slc", "stc"}

    for name, f in sfc.items():
        if name in ("slmsk", "vtype", "stype"):
            continue
        if name in plain:
            out[name] = _masked_wavg(f, area, true_mask, factor)
        elif name in over_dom:
            out[name] = _masked_wavg(f, area, dom_sfc, factor)
        elif name in vfrac_weighted:
            # area*vfrac weights over dominant sfc+vtype, falling back
            # to plain area weights where vfrac sums to zero (:1151)
            m = dom_vtype
            a_avg = _masked_wavg(f, area, m, factor)
            out[name] = _masked_wavg(
                f, area * vfrac, m, factor, fallback=a_avg
            )
        elif name in soil:
            # soil columns [..., zsoil, y, x] or surface [..., y, x]
            if f.shape == area.shape:
                m, a = dom_stype, area
            else:  # [tile, zsoil, y, x]: insert the level axis
                m = np.broadcast_to(
                    dom_stype[..., None, :, :], f.shape
                )
                a = np.broadcast_to(area[..., None, :, :], f.shape)
            out[name] = _masked_wavg(f, a, m, factor)
        elif name == "srflag":
            out[name] = block_mode(f, factor)
        elif name == "slope":
            out[name] = _masked_mode(f, dom_sfc, factor)
        elif name == "sheleg":
            out[name] = _masked_wavg(f, area * sncovr, true_mask, factor)
        elif name == "hice":
            out[name] = _masked_wavg(f, area * fice, true_mask, factor)
        elif name == "shdmin":
            out[name] = _masked_reduce(f, dom_sfc, factor, "min")
        elif name in ("shdmax", "snoalb"):
            out[name] = _masked_reduce(f, dom_sfc, factor, "max")
        elif name == "tisfc":
            sea_ice = _masked_wavg(f, area * fice, dom_sfc, factor)
            other = _masked_wavg(f, area, dom_sfc, factor)
            out[name] = np.where(
                np.isclose(coarse_slmsk, 2.0), sea_ice, other
            )
        else:
            out[name] = _masked_wavg(f, area, true_mask, factor)

    return apply_surface_chgres_corrections(out)


def apply_surface_chgres_corrections(
    ds: Dict[str, "np.ndarray"]
) -> Dict[str, "np.ndarray"]:
    """surface_chgres.f90 corrections (coarsen_restarts.py:1355-1411);
    host code (tensors are read to the host)."""
    out = {k: to_host(v) for k, v in ds.items()}
    # Reference ordering (surface_chgres steps 1-4): temperature caps and
    # stype over land ice first, then the canopy rule evaluated against the
    # PRE-correction shdmin, and only last zero shdmin over land ice — so a
    # land-ice cell with shdmin >= threshold keeps its canopy moisture.
    if "canopy" in out and "shdmin" in out:
        out["canopy"] = np.where(
            out["shdmin"] < SHDMIN_THRESHOLD, 0.0, out["canopy"]
        )
    if "vtype" in out:
        land_ice = np.isclose(out["vtype"], VTYPE_LAND_ICE)
        for name in ("tsea", "tg3"):
            if name in out:
                out[name] = np.where(
                    land_ice,
                    np.minimum(out[name], FREEZING_TEMPERATURE),
                    out[name],
                )
        if "stype" in out:
            out["stype"] = np.where(
                land_ice, STYPE_LAND_ICE, out["stype"]
            )
        if "shdmin" in out:
            out["shdmin"] = np.where(land_ice, 0.0, out["shdmin"])
    return {
        k: np.asarray(v, np.float32) if np.asarray(v).dtype == np.float64
        else v
        for k, v in out.items()
    }
