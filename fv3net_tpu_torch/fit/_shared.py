"""ML framework core abstractions (the JAX package's ``fit/_shared.py``;
fv3fit/_shared equivalents).

The Predictor contract, the io registry with its ``name`` file, array
packing of named fields to (sample, feature) matrices and back, and the
standard scaler.  Arrays may be numpy arrays or torch tensors; packing
keeps the kind it is given, so a state on the GPU stays there.  The
training registry and configs wait for the training slice (ROADMAP).
"""

from __future__ import annotations

import abc
import json
import os
from typing import Dict, Iterable, Mapping, Sequence

import numpy as np
import torch

from ..util.quantity import Quantity

State = Mapping[str, Quantity]

_IO_REGISTRY: Dict[str, type] = {}
_NAME_FILE = "name"


class Predictor(abc.ABC):
    """The prediction contract (fv3fit/_shared/predictor.py:44)."""

    def __init__(
        self,
        input_variables: Iterable[str],
        output_variables: Iterable[str],
    ):
        self.input_variables = list(input_variables)
        self.output_variables = list(output_variables)

    @abc.abstractmethod
    def predict(self, X: State) -> State:
        ...

    @classmethod
    def load(cls, path: str) -> "Predictor":
        raise NotImplementedError


def register(name: str):
    """Class decorator adding the model type to the io registry
    (io.py:17)."""

    def wrap(cls):
        _IO_REGISTRY[name] = cls
        cls._io_name = name
        return cls

    return wrap


def load(path: str):
    """Load a model directory written by the JAX package's ``fit.dump``
    (io.py:71): its ``name`` file selects the class."""
    with open(os.path.join(path, _NAME_FILE)) as f:
        name = f.read().strip()
    if name not in _IO_REGISTRY:
        raise NotImplementedError(
            f"model type {name!r} is not ported (ported: "
            f"{sorted(_IO_REGISTRY)})"
        )
    return _IO_REGISTRY[name].load(path)


def _columns(arr):
    """[tile, z, y, x] -> [samples, z]; [tile, y, x] -> [samples, 1];
    [sample, feature] unchanged (numpy or torch)."""
    if arr.ndim == 4:
        nz = arr.shape[1]
        if isinstance(arr, torch.Tensor):
            return torch.movedim(arr, 1, -1).reshape(-1, nz)
        return np.moveaxis(arr, 1, -1).reshape(-1, nz)
    if arr.ndim == 3:
        return arr.reshape(-1, 1)
    if arr.ndim == 2:
        return arr
    raise ValueError(f"bad rank: {tuple(arr.shape)}")


class ArrayPacker:
    """Stack named fields into a (sample, feature) matrix and back
    (fv3fit/_shared/packer.py:45; stacking.py:12): 3D fields become
    per-column feature blocks of width nz, 2D fields one feature."""

    def __init__(self, names: Sequence[str]):
        self.names = list(names)
        self._feature_counts: Dict[str, int] = {}

    def to_array(self, state: State):
        blocks = []
        for name in self.names:
            arr = state[name].data
            if not isinstance(arr, torch.Tensor):
                arr = np.asarray(arr)
            block = _columns(arr)
            self._feature_counts[name] = block.shape[1]
            blocks.append(block)
        if any(isinstance(b, torch.Tensor) for b in blocks):
            return torch.cat([torch.as_tensor(b) for b in blocks], dim=1)
        return np.concatenate(blocks, axis=1)

    def to_state(self, array, template: State) -> Dict[str, Quantity]:
        out = {}
        i = 0
        for name in self.names:
            width = self._feature_counts[name]
            block = array[:, i : i + width]
            i += width
            tq = template[name]
            tshape = tq.shape
            if len(tshape) == 4:
                arr = block.reshape(tshape[0], tshape[2], tshape[3],
                                    tshape[1])
                arr = (
                    torch.movedim(arr, -1, 1)
                    if isinstance(arr, torch.Tensor)
                    else np.moveaxis(arr, -1, 1)
                )
            elif len(tshape) == 3:
                arr = block.reshape(tshape)
            else:
                arr = block
            out[name] = tq.with_data(arr)
        return out

    @classmethod
    def load_from(cls, path: str) -> "ArrayPacker":
        with open(path) as f:
            d = json.load(f)
        p = cls(d["names"])
        p._feature_counts = {
            k: int(v) for k, v in d["feature_counts"].items()
        }
        return p


class StandardScaler:
    """(fv3fit/_shared/scaler.py): mean and std as host numpy arrays
    (fitting them waits for the training slice)."""

    def __init__(self):
        self.mean = None
        self.std = None

    def normalize(self, X):
        return (X - self.mean) / self.std

    def denormalize(self, X):
        return X * self.std + self.mean

    @classmethod
    def load_from(cls, path: str) -> "StandardScaler":
        with np.load(path) as d:
            s = cls()
            s.mean = d["mean"]
            s.std = d["std"]
        return s
