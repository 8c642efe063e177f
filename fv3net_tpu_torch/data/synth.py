"""Schema-driven synthetic test fixtures (external/synth/synth/core.py; a
copy of the JAX package's ``data/synth.py``).

The reference stores dataset *schemas* (dims, shapes, dtypes, chunks
per variable) as JSON next to its tests and generates realistic random
datasets from them (`synth/core.py:108-256` generate /
read_schema_from_zarr), so fixtures track production data layouts
without shipping data.  Same machinery here over the framework's
Quantity-dict State and zarr-lite stores: read a schema from a store
(or JSON), generate uniform-random data per variable within configured
Ranges, dump/load schemas as JSON.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..util.quantity import Quantity


@dataclasses.dataclass
class Range:
    """(core.py:35)"""

    min: float = -1000.0
    max: float = 1000.0


@dataclasses.dataclass
class VariableSchema:
    """(core.py:60 VariableSchema + ChunkedArray)"""

    name: str
    dims: Tuple[str, ...]
    shape: Tuple[int, ...]
    dtype: str = "float32"
    attrs: Dict = dataclasses.field(default_factory=dict)

    def generate(self, range_: Range, rng: np.random.RandomState):
        arr = rng.uniform(
            range_.min, range_.max, self.shape
        ).astype(self.dtype)
        return Quantity(
            arr, tuple(self.dims),
            str(self.attrs.get("units", "")), dict(self.attrs),
        )


@dataclasses.dataclass
class CoordinateSchema:
    """(core.py:49)"""

    name: str
    dims: Tuple[str, ...]
    value: np.ndarray
    attrs: Dict = dataclasses.field(default_factory=dict)

    def generate(self):
        return Quantity(
            np.asarray(self.value), tuple(self.dims),
            str(self.attrs.get("units", "")), dict(self.attrs),
        )


@dataclasses.dataclass
class DatasetSchema:
    """(core.py:106)"""

    coords: Dict[str, CoordinateSchema] = dataclasses.field(
        default_factory=dict
    )
    variables: Dict[str, VariableSchema] = dataclasses.field(
        default_factory=dict
    )


def generate(
    schema: DatasetSchema,
    ranges: Optional[Mapping[str, Range]] = None,
    seed: int = 0,
) -> Dict[str, Quantity]:
    """Random State matching the schema (core.py:generate): every
    variable uniform within its Range (default +/-1000, core.py:135)."""
    rng = np.random.RandomState(seed)
    ranges = dict(ranges or {})
    default = Range(-1000, 1000)
    out: Dict[str, Quantity] = {}
    for name, cs in schema.coords.items():
        out[name] = cs.generate()
    for name, vs in schema.variables.items():
        out[name] = vs.generate(ranges.get(name, default), rng)
    return out


_COORD_NAMES = (
    "forecast_time", "time", "initial_time", "tile", "step", "z", "y",
    "x", "latitude", "longitude",
)


def read_schema_from_zarr(
    path: str, coords: Sequence[str] = _COORD_NAMES
) -> DatasetSchema:
    """Schema of an existing zarr-lite store (core.py:147)."""
    from ..io.zarr_lite import ZarrLiteStore

    store = ZarrLiteStore(path)
    schema = DatasetSchema()
    for name in store.arrays():
        attrs = dict(store.attrs(name))
        dims = tuple(attrs.pop("_ARRAY_DIMENSIONS", ()))
        meta = store._meta(name)
        shape = tuple(meta.get("shape") or store.read(name).shape)
        dtype = str(
            np.dtype(meta["dtype"].lstrip("<>|="))
            if meta.get("dtype")
            else store.read(name).dtype
        )
        if name in coords:
            schema.coords[name] = CoordinateSchema(
                name, dims or (name,), store.read(name), attrs
            )
        else:
            schema.variables[name] = VariableSchema(
                name, dims, shape, dtype, attrs
            )
    return schema


def read_schema_from_state(
    state: Mapping[str, Quantity], coords: Sequence[str] = _COORD_NAMES
) -> DatasetSchema:
    """Schema of an in-memory State."""
    schema = DatasetSchema()
    for name, q in state.items():
        if name in coords:
            schema.coords[name] = CoordinateSchema(
                name, q.dims, q.values, dict(q.attrs)
            )
        else:
            schema.variables[name] = VariableSchema(
                name, q.dims, tuple(q.shape), str(q.dtype),
                {"units": q.units, **q.attrs},
            )
    return schema


def dump_schema(schema: DatasetSchema, path: str) -> None:
    """JSON serialization (core.py:dump / dumps)."""
    doc = {
        "version": "v3",
        "schema": {
            "coords": {
                k: {
                    "name": v.name, "dims": list(v.dims),
                    "value": np.asarray(v.value).tolist(),
                    "attrs": v.attrs,
                }
                for k, v in schema.coords.items()
            },
            "variables": {
                k: {
                    "name": v.name, "dims": list(v.dims),
                    "shape": list(v.shape), "dtype": v.dtype,
                    "attrs": v.attrs,
                }
                for k, v in schema.variables.items()
            },
        },
    }
    with open(path, "w") as f:
        json.dump(doc, f)


def load_schema(path: str) -> DatasetSchema:
    """(core.py:load / loads)"""
    with open(path) as f:
        doc = json.load(f)
    body = doc.get("schema", doc)
    schema = DatasetSchema()
    for k, v in body.get("coords", {}).items():
        schema.coords[k] = CoordinateSchema(
            v["name"], tuple(v["dims"]), np.asarray(v["value"]),
            v.get("attrs", {}),
        )
    for k, v in body.get("variables", {}).items():
        schema.variables[k] = VariableSchema(
            v["name"], tuple(v["dims"]), tuple(v["shape"]),
            v.get("dtype", "float32"), v.get("attrs", {}),
        )
    return schema
