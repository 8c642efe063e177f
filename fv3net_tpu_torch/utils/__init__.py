"""Utilities of the port (the JAX package's ``utils/``): thermodynamics,
the solar zenith angle, block coarsening (``coarsen``), the restart and
surface coarsening (``coarsen_restarts``), the fine-resolution budget
(``fine_res_budget``), vertical interpolation (``interpolate``), skill
metrics (``metrics``), and the host helpers ``rotate``, ``fv3logs`` and
``artifacts``.  The names exported here are the JAX package's."""

from . import thermo
from .zenith import cos_zenith_angle
from .coarsen import (
    block_coarsen,
    block_edge_sum,
    block_median,
    block_mode,
    block_upsample,
    edge_weighted_block_average,
    weighted_block_average,
    xarray_block_reduce,
)
from .coarsen_restarts import (
    coarsen_restarts_on_sigma,
    coarsen_restarts_on_pressure,
    coarsen_restarts_via_blended_method,
    coarsen_sfc_data,
    impose_hydrostatic_balance,
    mass_weighted_block_average,
    blending_weight,
)
from .interpolate import (
    interpolate_1d,
    interpolate_to_pressure_levels,
    PRESSURE_GRID,
)
from .metrics import (
    r2_score,
    mean_squared_error,
    root_mean_squared_error,
    mean_absolute_error,
    bias,
    accuracy,
    precision,
    recall,
    f1_score,
    false_positive_rate,
    histogram,
    histogram2d,
    zonal_average_approximate,
    register_data_transform,
    apply_data_transform,
    DATA_TRANSFORM_REGISTRY,
)

__all__ = [
    "thermo",
    "cos_zenith_angle",
    "block_coarsen",
    "block_edge_sum",
    "block_median",
    "block_mode",
    "block_upsample",
    "edge_weighted_block_average",
    "weighted_block_average",
    "xarray_block_reduce",
    "coarsen_restarts_on_sigma",
    "coarsen_restarts_on_pressure",
    "coarsen_restarts_via_blended_method",
    "coarsen_sfc_data",
    "impose_hydrostatic_balance",
    "mass_weighted_block_average",
    "blending_weight",
    "interpolate_1d",
    "interpolate_to_pressure_levels",
    "PRESSURE_GRID",
    "r2_score",
    "mean_squared_error",
    "root_mean_squared_error",
    "mean_absolute_error",
    "bias",
    "accuracy",
    "precision",
    "recall",
    "f1_score",
    "false_positive_rate",
    "histogram",
    "histogram2d",
    "zonal_average_approximate",
    "register_data_transform",
    "apply_data_transform",
    "DATA_TRANSFORM_REGISTRY",
]
