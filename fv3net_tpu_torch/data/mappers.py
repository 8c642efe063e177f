"""Training-data mappers (a copy of the JAX package's ``data/mappers.py``;
the loaders package's mapper layer:
loaders/mappers/_nudged/_nudged.py:22,118,190,
loaders/mappers/_fine_res.py:99,216, loaders/_config.py:14-56).

A *mapper* is a Mapping[timestamp -> State] assembled from run output
stores, with the reference's renaming conventions that turn nudging /
fine-resolution budget outputs into ML training targets (dQ1/dQ2/dQu/
dQv for the apparent heating, moistening and momentum sources).  Keys
use the reference's %Y%m%d.%H%M%S timestep format
(vcm convenience.py TIME_FMT).

Sources are zarr-lite stores written by the runtime's diagnostics
manager / segmented runs; everything composes with
BatchesFromMapperConfig to feed the fit trainers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np

from ..io.zarr_lite import ZarrLiteStore
from ..util.quantity import Quantity
from .batches import register_batches_function

TIME_FMT = "%Y%m%d.%H%M%S"

mapper_functions: Dict[str, Callable] = {}


def register_mapper_function(name):
    """(loaders/_config.py:14 FunctionRegister)"""

    def wrap(fn):
        mapper_functions[name] = fn
        return fn

    return wrap


class GeoMapper(Mapping):
    """Base mapper: timestamps -> State dicts (loaders/mappers/_base)."""

    def __init__(self, states: Mapping[str, Mapping[str, Quantity]]):
        self._states = dict(states)

    def __getitem__(self, key):
        return self._states[key]

    def __iter__(self):
        return iter(self._states)

    def __len__(self):
        return len(self._states)

    def keys(self):
        return self._states.keys()


def _read_zarr_states(path: str,
                      variables: Optional[Sequence[str]] = None):
    """Read a time-indexed zarr-lite store into per-time State dicts.
    Returns (times, list-of-state-dicts)."""
    store = ZarrLiteStore(path)
    names = list(variables) if variables else [
        a for a in store.arrays() if a != "time"
    ]
    arrays, dims = {}, {}
    for v in names:
        arrays[v] = store.read(v)
        dims[v] = tuple(store.attrs(v).get("_ARRAY_DIMENSIONS", ()))
    nt = min(a.shape[0] for a in arrays.values())
    times = None
    try:
        times = [str(t) for t in store.read("time")[:nt]]
    except Exception:
        times = [f"{i:08d}.000000" for i in range(nt)]
    states = []
    for i in range(nt):
        states.append(
            {
                v: Quantity(arrays[v][i], dims[v][1:], "")
                for v in names
                if v != "time"
            }
        )
    return times, states


@register_mapper_function("open_zarr")
def open_zarr(path: str, variables=None) -> GeoMapper:
    times, states = _read_zarr_states(path, variables)
    return GeoMapper(dict(zip(times, states)))


NUDGE_TO_FINE_RENAMES = {
    # (loaders/mappers/_nudged/_nudged.py:118): nudging tendencies of a
    # nudged-to-fine run become the apparent-source training targets
    "air_temperature_tendency_due_to_nudging": "dQ1",
    "specific_humidity_tendency_due_to_nudging": "dQ2",
    "x_wind_tendency_due_to_nudging": "dQxwind",
    "y_wind_tendency_due_to_nudging": "dQywind",
    "eastward_wind_tendency_due_to_nudging": "dQu",
    "northward_wind_tendency_due_to_nudging": "dQv",
}

NUDGE_TO_OBS_RENAMES = {
    # (loaders/mappers/_nudged/_nudged.py:22): GFS-analysis nudging
    "tendency_of_air_temperature_due_to_nudging": "dQ1",
    "tendency_of_specific_humidity_due_to_nudging": "dQ2",
    "tendency_of_eastward_wind_due_to_nudging": "dQu",
    "tendency_of_northward_wind_due_to_nudging": "dQv",
}


def _merge_renamed(mappers_and_renames):
    """Merge several (times, states, renames) sources on shared keys."""
    keysets = [set(t) for t, _, _ in mappers_and_renames]
    shared = sorted(set.intersection(*keysets))
    out = {}
    for key in shared:
        merged = {}
        for times, states, renames in mappers_and_renames:
            st = states[times.index(key)]
            for name, q in st.items():
                merged[renames.get(name, name)] = q
        out[key] = merged
    return GeoMapper(out)


@register_mapper_function("open_nudge_to_fine")
def open_nudge_to_fine(
    url: str,
    nudging_variables: Sequence[str] = (),
    state_zarr: str = "state_after_timestep.zarr",
    tendency_zarr: str = "nudging_tendencies.zarr",
) -> GeoMapper:
    """(loaders/mappers/_nudged/_nudged.py:118): merge a nudged-to-fine
    run's state output with its nudging tendencies renamed to dQ*."""
    import os

    t1, s1 = _read_zarr_states(os.path.join(url, state_zarr))
    t2, s2 = _read_zarr_states(os.path.join(url, tendency_zarr))
    return _merge_renamed(
        [(t1, s1, {}), (t2, s2, NUDGE_TO_FINE_RENAMES)]
    )


@register_mapper_function("open_nudge_to_obs")
def open_nudge_to_obs(
    url: str,
    state_zarr: str = "state_after_timestep.zarr",
    tendency_zarr: str = "nudging_tendencies.zarr",
    physics_zarr: Optional[str] = None,
) -> GeoMapper:
    """(loaders/mappers/_nudged/_nudged.py:22)"""
    import os

    sources = []
    t1, s1 = _read_zarr_states(os.path.join(url, state_zarr))
    sources.append((t1, s1, {}))
    t2, s2 = _read_zarr_states(os.path.join(url, tendency_zarr))
    sources.append((t2, s2, NUDGE_TO_OBS_RENAMES))
    if physics_zarr:
        t3, s3 = _read_zarr_states(os.path.join(url, physics_zarr))
        sources.append((t3, s3, {}))
    return _merge_renamed(sources)


@register_mapper_function("open_nudge_to_fine_multiple_datasets")
def open_nudge_to_fine_multiple_datasets(
    urls: Sequence[str], **kwargs
) -> GeoMapper:
    """(loaders/mappers/_nudged/_nudged.py:190): concatenate several
    nudged runs; keys get a per-run suffix to stay unique."""
    out = {}
    for i, url in enumerate(urls):
        m = open_nudge_to_fine(url, **kwargs)
        for k in m:
            out[f"{k}.run{i}"] = m[k]
    return GeoMapper(out)


@dataclasses.dataclass
class DynamicsDifferenceApparentSource:
    """(loaders/mappers/_fine_res.py:99): apparent source =
    (fine dynamics tendency - coarse dynamics tendency)
    + fine physics tendency, computed lazily per state."""

    fine_dynamics: str
    coarse_dynamics: str
    fine_physics: str

    def compute(self, state) -> np.ndarray:
        return (
            np.asarray(state[self.fine_dynamics].values)
            - np.asarray(state[self.coarse_dynamics].values)
            + np.asarray(state[self.fine_physics].values)
        )


FINE_RES_SOURCES = {
    "Q1": DynamicsDifferenceApparentSource(
        "T_tendency_due_to_dynamics_fine",
        "T_tendency_due_to_dynamics_coarse",
        "T_tendency_due_to_physics_fine",
    ),
    "Q2": DynamicsDifferenceApparentSource(
        "sphum_tendency_due_to_dynamics_fine",
        "sphum_tendency_due_to_dynamics_coarse",
        "sphum_tendency_due_to_physics_fine",
    ),
}


@register_mapper_function("open_fine_resolution")
def open_fine_resolution(
    path: str, sources: Mapping = None
) -> GeoMapper:
    """(loaders/mappers/_fine_res.py:216): compute fine-resolution
    apparent sources Q1/Q2 from a budget store holding the fine/coarse
    dynamics and physics tendencies."""
    sources = sources or FINE_RES_SOURCES
    times, states = _read_zarr_states(path)
    out = {}
    for t, st in zip(times, states):
        st = dict(st)
        ref = next(iter(st.values()))
        for name, src in sources.items():
            st[name] = Quantity(src.compute(st), ref.dims, "")
        out[t] = st
    return GeoMapper(out)


@dataclasses.dataclass
class MapperConfig:
    """(loaders/_config.py:28): {"function": ..., "kwargs": ...}"""

    function: str
    kwargs: dict = dataclasses.field(default_factory=dict)

    def open_mapper(self) -> GeoMapper:
        return mapper_functions[self.function](**self.kwargs)


@dataclasses.dataclass
class BatchesFromMapperConfig:
    """(loaders/batches/_batch.py:44): select timesteps from a mapper
    and expose them as training batches, optionally subsampled and
    shuffled."""

    mapper_config: MapperConfig
    variable_names: Sequence[str] = ()
    timesteps: Optional[Sequence[str]] = None
    timesteps_per_batch: int = 1
    shuffle_seed: Optional[int] = None

    def load_batches(self):
        mapper = self.mapper_config.open_mapper()
        keys = list(self.timesteps or sorted(mapper.keys()))
        if self.shuffle_seed is not None:
            rng = np.random.RandomState(self.shuffle_seed)
            rng.shuffle(keys)
        batches = []
        for i in range(0, len(keys), self.timesteps_per_batch):
            chunk = keys[i : i + self.timesteps_per_batch]
            states = [mapper[k] for k in chunk]
            if len(states) == 1:
                st = states[0]
            else:  # concatenate along tile axis
                st = {}
                names = self.variable_names or states[0].keys()
                for name in names:
                    qs = [s[name] for s in states]
                    st[name] = Quantity(
                        np.concatenate(
                            [np.asarray(q.values) for q in qs]
                        ),
                        qs[0].dims, qs[0].units,
                    )
            if self.variable_names:
                st = {k: st[k] for k in self.variable_names}
            batches.append(st)
        return batches


@register_batches_function("batches_from_mapper")
def batches_from_mapper(
    mapper_function: str,
    mapper_kwargs: dict = None,
    variable_names: Sequence[str] = (),
    timesteps: Optional[Sequence[str]] = None,
    timesteps_per_batch: int = 1,
    shuffle_seed: Optional[int] = None,
):
    return BatchesFromMapperConfig(
        MapperConfig(mapper_function, mapper_kwargs or {}),
        variable_names=variable_names,
        timesteps=timesteps,
        timesteps_per_batch=timesteps_per_batch,
        shuffle_seed=shuffle_seed,
    ).load_batches()
