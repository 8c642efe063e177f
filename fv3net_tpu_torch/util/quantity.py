"""Named-array state container (pace.util.Quantity equivalent).

Counterpart of the JAX package's ``util/quantity.py``: a Quantity is an
array (a torch tensor or a numpy array) + dims + units + attrs, and a
State is a plain dict of name -> Quantity.  Tensors stay on their device
until ``.values`` is read.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Quantity:
    data: Any  # torch.Tensor or np.ndarray
    dims: Tuple[str, ...]
    units: str = ""
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if len(self.dims) != getattr(self.data, "ndim", len(self.dims)):
            raise ValueError(
                f"dims {self.dims} do not match array rank "
                f"{self.data.ndim}"
            )

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def values(self) -> np.ndarray:
        """The data as a host numpy array (a device-to-host copy for a
        tensor on the GPU)."""
        if isinstance(self.data, torch.Tensor):
            return self.data.detach().cpu().numpy()
        return np.asarray(self.data)

    def with_data(self, data) -> "Quantity":
        return Quantity(data, self.dims, self.units, dict(self.attrs))

    def transpose(self, dims: Tuple[str, ...]) -> "Quantity":
        perm = tuple(self.dims.index(d) for d in dims)
        return Quantity(
            np.transpose(self.values, perm), dims, self.units,
            dict(self.attrs),
        )

    def __repr__(self):
        return (
            f"Quantity(dims={self.dims}, shape={self.shape}, "
            f"units={self.units!r})"
        )


State = Dict[str, Quantity]


def state_to_numpy(state: Mapping[str, Quantity]) -> State:
    return {k: v.with_data(v.values) for k, v in state.items()}
