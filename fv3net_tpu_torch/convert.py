"""Carry the JAX package's dycore inputs across as torch tensors.

The dycore has no trained weights: its "weights" are the metric terms
(``dycore.sw.SWMetrics``) and the hybrid coordinate.  These helpers take
plain numpy arrays -- e.g. ``np.asarray`` of every array field of a JAX
``SWMetrics`` or ``DycoreState`` -- so that both packages can step with
identical inputs.  Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .dycore.hydro import DycoreState
from .dycore.sw import SWMetrics


def metrics_from_numpy(arrays: Mapping, device="cpu",
                       dtype=None) -> SWMetrics:
    """SWMetrics from a mapping holding every tensor field of SWMetrics
    as an array, plus `n`, `halo` and `divdamp_scale`.  Keys the port
    has no field for (None-valued tiling fields, scheme switches) are
    ignored.  dtype: cast the arrays (default: keep theirs)."""
    kw = {}
    for f in dataclasses.fields(SWMetrics):
        if f.name in ("n", "halo"):
            kw[f.name] = int(arrays[f.name])
        elif f.name == "divdamp_scale":
            kw[f.name] = float(arrays[f.name])
        else:
            kw[f.name] = torch.as_tensor(
                np.array(arrays[f.name]), dtype=dtype, device=device
            )
    return SWMetrics(**kw)


def state_from_numpy(arrays: Mapping, device="cpu",
                     dtype=None) -> DycoreState:
    """DycoreState from a mapping of field name -> array (or None)."""
    return DycoreState(**{
        k: None if arrays.get(k) is None else torch.as_tensor(
            np.array(arrays[k]), dtype=dtype, device=device
        )
        for k in DycoreState._fields
    })


def state_to_numpy(state: DycoreState) -> dict:
    """Field name -> numpy array (or None) of a DycoreState."""
    return {
        k: None if v is None else v.detach().cpu().numpy()
        for k, v in state._asdict().items()
    }
