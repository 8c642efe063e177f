"""Per-step global scalar metrics (the JAX package's
``runtime/metrics.py``; the reference's runtime/metrics.py semantics).

Area-weighted global reductions of selected fields, emitted as one JSON
mapping per step and validated.  The reference reduces over MPI ranks
(metrics.py:18-33, comm.reduce); here the cube is resident on the
model's device, so each reduction runs there in float64 and only its
scalar comes to the host.
"""

from __future__ import annotations

import json
import logging
from typing import Mapping

import numpy as np
import torch

from ..constants import GRAV
from . import names

logger = logging.getLogger("statistics")

METRICS_SCHEMA = {
    "type": "object",
    "patternProperties": {".*": {"type": "number"}},
}


def _f64(x, device=None):
    return torch.as_tensor(x, device=device).to(torch.float64)


def globally_average_2d(q, area) -> float:
    q = _f64(q)
    area = _f64(area, q.device)
    return float((q * area).sum() / area.sum())


def global_sum_2d(q, area) -> float:
    q = _f64(q)
    return float((q * _f64(area, q.device)).sum())


def compute_metrics(state, area: np.ndarray) -> Mapping[str, float]:
    """The reference's standard per-step global statistics."""
    delp = _f64(state[names.DELP].data)
    sphum = _f64(state[names.SPHUM].data, delp.device)
    area = _f64(area, delp.device)
    out = {
        "area_mean_surface_pressure": globally_average_2d(
            delp.sum(1), area
        ),
        "global_average_water_vapor_path": globally_average_2d(
            (sphum * delp / GRAV).sum(1), area
        ),
        "total_mass": global_sum_2d(delp.sum(1) / GRAV, area),
    }
    try:
        precip = state[names.TOTAL_PRECIP].data
        out["global_average_total_precipitation_m"] = (
            globally_average_2d(precip, area)
        )
    except KeyError:
        pass
    return out


def validate_metrics(metrics: Mapping[str, float]):
    for k, v in metrics.items():
        if not isinstance(v, (int, float)) or not np.isfinite(v):
            raise ValueError(f"metric {k!r} is not a finite number: {v}")


def log_metrics(metrics: Mapping[str, float], time=None):
    validate_metrics(metrics)
    payload = dict(metrics)
    if time is not None:
        payload["time"] = str(time)
    logger.info(json.dumps(payload))
