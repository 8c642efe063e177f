"""Training data (numpy): batches, sequences, mappers and synthetic
fixtures, copied from the JAX package's ``data/``."""

from .batches import (
    batches_from_zarr,
    open_batches_from_config,
    batches_functions,
    SyntheticWaves,
    SyntheticNoise,
)
from .sequences import Map, Local, shuffle, to_local
from .mappers import (
    GeoMapper,
    MapperConfig,
    BatchesFromMapperConfig,
    DynamicsDifferenceApparentSource,
    mapper_functions,
    register_mapper_function,
    open_zarr,
    open_nudge_to_fine,
    open_nudge_to_obs,
    open_nudge_to_fine_multiple_datasets,
    open_fine_resolution,
    batches_from_mapper,
)

__all__ = [
    "GeoMapper",
    "MapperConfig",
    "BatchesFromMapperConfig",
    "DynamicsDifferenceApparentSource",
    "mapper_functions",
    "register_mapper_function",
    "open_zarr",
    "open_nudge_to_fine",
    "open_nudge_to_obs",
    "open_nudge_to_fine_multiple_datasets",
    "open_fine_resolution",
    "batches_from_mapper",
    "batches_from_zarr",
    "open_batches_from_config",
    "batches_functions",
    "SyntheticWaves",
    "SyntheticNoise",
    "Map",
    "Local",
    "shuffle",
    "to_local",
]
