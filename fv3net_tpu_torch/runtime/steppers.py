"""The ML stepper's humidity limiter (the JAX package's
``runtime/steppers.py::non_negative_sphum``; the reference's
runtime/steppers/machine_learning.py:67-101)."""

from __future__ import annotations

import torch

from ..constants import CP_AIR, LATENT_HEAT_VAPORIZATION as LV


def non_negative_sphum(sphum, dQ1, dQ2, dt: float):
    """Moist-static-energy-conserving humidity limiter: where the
    predicted dQ2 would drive humidity negative, reduce it and compensate
    dQ1 so cp*dQ1 + Lv*dQ2 is unchanged."""
    delta = dQ2 * dt
    reduction_ratio = torch.where(
        (delta < 0) & (sphum + delta < 0),
        torch.clip(
            -sphum / torch.where(delta != 0, delta, torch.ones_like(delta)),
            0.0, 1.0,
        ),
        1.0,
    )
    dQ2_limited = dQ2 * reduction_ratio
    dQ1_limited = dQ1 + (LV / CP_AIR) * (dQ2 - dQ2_limited)
    return dQ1_limited, dQ2_limited
