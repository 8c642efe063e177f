"""The comparison that decides ``correct``.

A dt of the program is held against the plain reference's dt from the
same input state, field by field: the widest gap between the two
outputs over the widest value of the reference's output,

    gap = max |program - reference| / max |reference|,

a relative error of the state.  The program's float32 kernels round
otherwise than the reference's plain float32 operations, so the gap of a
sound dt is rounding carried through one dt; its absolute size stays
steady from seed to seed and along the run.  A field that is not finite
on either side reads infinity.
"""

from __future__ import annotations

import math

import torch

FIELDS = ("delp", "pt", "u", "v", "q", "w", "delz")


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().double(), want.detach().double()
    if not (bool(torch.isfinite(got).all())
            and bool(torch.isfinite(want).all())):
        return math.inf
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    if scale == 0.0:
        return 0.0 if diff == 0.0 else math.inf
    return diff / scale


def field_stats(got, want, before) -> dict:
    """The widest |got - want|, |want - before| and |want| of one field
    (what the gap is made of)."""
    got, want, before = (t.detach().double() for t in (got, want, before))
    return {"diff": float((got - want).abs().max()),
            "change": float((want - before).abs().max()),
            "mag": float(want.abs().max())}


def gaps(prefix: str, got, want) -> dict:
    """{prefix_field: gap} for every field the states carry."""
    return {f"{prefix}_{k}": gap(getattr(got, k), getattr(want, k))
            for k in FIELDS if getattr(got, k) is not None}


def judge(values: dict, limits: dict) -> bool:
    """Every number finite and at most its limit; a number with no limit
    fails."""
    return all(
        limits.get(k) is not None and math.isfinite(v) and v <= limits[k]
        for k, v in values.items()
    )
