"""Fine-resolution budget ingredients with eddy-flux decomposition.

The reference's fine_res_budget workflow coarsens C3072/C384 state to
the target grid ON SURFACES OF CONSTANT PRESSURE and computes the
second moments whose coarse-grained residuals are the eddy fluxes that
enter Q1/Q2 (workflows/fine_res_budget/budget/budgets.py:
Grid.pressure_level_average, compute_second_moments, storage,
area_above_fine_surface; README.md:1-30).  This module (the JAX
package's ``utils/fine_res_budget.py``) provides the same recipe over
torch tensors:

  * ``pressure_level_average``: vertical PPM regrid of a fine field to
    the (upsampled) coarse interface pressures, then area-weighted
    block averaging — the "coarsen on pressure surfaces" operator;
  * ``second_moments`` + ``eddy_flux``: bar(w T) - bar(w) bar(T) type
    decompositions (the resolved-vs-subgrid vertical flux split);
  * ``storage``: (end - begin)/dt tendencies;
  * ``exposed_area``: the area where the fine surface sits below the
    coarse pressure midpoint (terrain-intersection bookkeeping).

Fields are [tile, nz, y, x] (or [tile, y, x] for 2D), host arrays or
tensors.  ``pressure_level_average``, ``exposed_area`` and
``compute_budget_ingredients`` compute on a torch device -- the tensors'
own, or for host arrays ``device`` (the CUDA device unless the caller
names another) -- and return tensors there, as the JAX package's return
device arrays.  The remap is the ``ops.remap.ppm_remap`` unit, as the
JAX package jits ppm_remap: the K5 kernel for CUDA float32 tensors, in a
replayed graph.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..device import device_for
from ..ops.remap import ppm_remap
from .coarsen import block_coarsen, block_upsample, \
    weighted_block_average
from .thermo import (
    pressure_at_midpoint_log,
    pressure_interface,
    surface_pressure_from_delp,
)


def pressure_level_average(field, delp_fine, delp_coarse, area,
                           factor: int, device=None):
    """Coarsen a 3D field on constant-pressure surfaces
    (budgets.py Grid.pressure_level_average).

    field/delp_fine [tile, nz, yf, xf]; delp_coarse
    [tile, nz, yc, xc]; area [tile, yf, xf]; factor = yf // yc.  The
    conservative remap (iv 1, kord 9, exact boundaries) is the
    ``ppm_remap`` unit: K5 on CUDA float32 tensors.
    """
    dev = device_for((field, delp_fine, delp_coarse, area), device,
                     "pressure_level_average")
    field, delp_fine, delp_coarse, area = (
        torch.as_tensor(a, device=dev) for a in (field, delp_fine, delp_coarse, area))
    # interfaces accumulated in float64 and rounded once, as
    # coarsen_restarts._interface_pressure accumulates them
    pe_fine = pressure_interface(delp_fine.double(), axis=-3).to(
        delp_fine.dtype)
    pe_coarse_up = block_upsample(
        pressure_interface(delp_coarse.double(), axis=-3), factor
    ).to(delp_coarse.dtype)
    regridded = ppm_remap(
        field.movedim(1, 0), pe_fine.movedim(1, 0),
        pe_coarse_up.movedim(1, 0), iv=1, kord=9, exact_boundaries=True,
    ).movedim(0, 1)
    return weighted_block_average(regridded, area[:, None], factor)


def second_moments(
    fields: Mapping[str, np.ndarray],
    pairs: Sequence[Tuple[str, str]],
) -> Dict[str, np.ndarray]:
    """Products computed at FINE resolution (budgets.py
    compute_second_moments) — coarsening these alongside the first
    moments is what makes the eddy decomposition possible."""
    return {
        f"{a}_{b}": fields[a] * fields[b] for a, b in pairs
    }


def eddy_flux(mean_product, mean_a, mean_b):
    """bar(ab) - bar(a) bar(b): the subgrid (eddy) part of a flux
    after coarse-graining."""
    return mean_product - mean_a * mean_b


def storage(begin, end, time_step: float):
    """(end - begin)/dt (budgets.py storage)."""
    return (end - begin) / time_step


def exposed_area(delp_fine, delp_coarse, area, factor: int, device=None):
    """Area where the fine-resolution surface pressure exceeds the
    upsampled coarse pressure midpoint (budgets.py
    area_above_fine_surface), on the tensors' device or `device`."""
    dev = device_for((delp_fine, delp_coarse, area), device, "exposed_area")
    delp_fine, delp_coarse, area = (
        torch.as_tensor(a, device=dev) for a in (delp_fine, delp_coarse, area))
    p_c = pressure_at_midpoint_log(delp_coarse, axis=-3)
    p_c_up = block_upsample(p_c, factor)
    ps = surface_pressure_from_delp(delp_fine, axis=-3)
    masked = torch.where(
        p_c_up <= ps[:, None], area[:, None], torch.zeros_like(p_c_up)
    )
    return block_coarsen(masked, factor, "sum")


def compute_budget_ingredients(
    fine: Mapping[str, np.ndarray],
    delp_coarse,
    area,
    factor: int,
    flux_pairs: Sequence[Tuple[str, str]] = (
        ("omega", "air_temperature"),
        ("omega", "specific_humidity"),
    ),
    device=None,
) -> Dict[str, np.ndarray]:
    """The full recipe: coarsen first moments and second moments on
    pressure surfaces, return both plus the eddy decompositions
    (`eddy_<a>_<b>`) and the exposed area, as tensors on the fields'
    device, or for host arrays on `device` (the CUDA device unless the
    caller names another).

    fine must contain 'pressure_thickness_of_atmospheric_layer' plus
    every name referenced by flux_pairs.
    """
    dev = device_for([*fine.values(), delp_coarse, area], device,
                     "compute_budget_ingredients")
    fine = {k: torch.as_tensor(v, device=dev) for k, v in fine.items()}
    delp_coarse, area = (torch.as_tensor(a, device=dev)
                         for a in (delp_coarse, area))
    delp_fine = fine["pressure_thickness_of_atmospheric_layer"]
    moments = second_moments(fine, flux_pairs)
    out: Dict[str, np.ndarray] = {}
    names_3d = {
        k
        for k in list(fine) + list(moments)
        if k != "pressure_thickness_of_atmospheric_layer"
    }
    merged = {**fine, **moments}
    for name in sorted(names_3d):
        out[name] = pressure_level_average(
            merged[name], delp_fine, delp_coarse, area, factor
        )
    for a, b in flux_pairs:
        out[f"eddy_{a}_{b}"] = eddy_flux(
            out[f"{a}_{b}"], out[a], out[b]
        )
    out["exposed_area"] = exposed_area(
        delp_fine, delp_coarse, area, factor
    )
    return out
