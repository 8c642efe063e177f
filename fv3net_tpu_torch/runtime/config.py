"""Layered run configuration (runtime/config.py semantics; a copy of the
JAX package's ``runtime/config.py``).

One YAML holds both the model namelist-style keys and the runtime keys;
runtime keys are everything not in FV3CONFIG_KEYS (config.py:20-33) and
deserialize STRICTLY into the UserConfig dataclass tree -- unknown keys
raise, like the reference's dacite.from_dict(strict) usage
(config.py:76-86).  A minimal strict from_dict lives here, so
the package does not depend on dacite.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Mapping, Optional, Sequence

import yaml

from .steppers import (
    MachineLearningConfig,
    NudgingConfig,
    TendencyPrescriberConfig,
)

FV3CONFIG_KEYS = {
    "namelist",
    "experiment_name",
    "initial_conditions",
    "forcing",
    "orographic_forcing",
    "patch_files",
    "diag_table",
    "data_table",
    "field_table",
    "gfs_analysis_data",
}


def from_dict(cls, data: Mapping[str, Any]):
    """Strict dataclass deserialization (dacite-equivalent subset)."""
    if not dataclasses.is_dataclass(cls):
        return data
    hints = typing.get_type_hints(cls)
    field_names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - field_names
    if unknown:
        raise ValueError(
            f"unknown keys for {cls.__name__}: {sorted(unknown)}"
        )
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        value = data[f.name]
        ftype = hints[f.name]
        origin = typing.get_origin(ftype)
        args = typing.get_args(ftype)
        if origin is typing.Union and type(None) in args:
            inner = [a for a in args if a is not type(None)][0]
            kwargs[f.name] = (
                None if value is None else _convert(inner, value)
            )
        else:
            kwargs[f.name] = _convert(ftype, value)
    return cls(**kwargs)


def _convert(ftype, value):
    import collections.abc

    origin = typing.get_origin(ftype)
    if dataclasses.is_dataclass(ftype) and isinstance(value, Mapping):
        return from_dict(ftype, value)
    if origin in (
        list, tuple, collections.abc.Sequence
    ) and isinstance(value, (list, tuple)):
        args = typing.get_args(ftype)
        if args and dataclasses.is_dataclass(args[0]):
            return [from_dict(args[0], v) for v in value]
        return list(value)
    return value


@dataclasses.dataclass
class DiagnosticFileConfig:
    name: str = "diags.zarr"
    variables: Sequence[str] = dataclasses.field(default_factory=list)
    times: "TimeConfig" = dataclasses.field(
        default_factory=lambda: TimeConfig()
    )
    chunks: Mapping[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TimeConfig:
    """Time selection (runtime/diagnostics/time.py:126): kind is one of
    'every', 'interval', 'selected'."""

    kind: str = "every"
    frequency: Optional[float] = None
    times: Sequence[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RadiationSchemeConfig:
    kind: str = "none"
    input_generator: Optional[str] = None


@dataclasses.dataclass
class BiasCorrectionConfig:
    tendency_prediction_path: Optional[str] = None


@dataclasses.dataclass
class UserConfig:
    """The runtime configuration tree (runtime/config.py:36-67)."""

    diagnostics: Sequence[DiagnosticFileConfig] = dataclasses.field(
        default_factory=list
    )
    fortran_diagnostics: Sequence[DiagnosticFileConfig] = (
        dataclasses.field(default_factory=list)
    )
    prephysics: Optional[Sequence[Mapping[str, Any]]] = None
    scikit_learn: Optional[MachineLearningConfig] = None
    nudging: Optional[NudgingConfig] = None
    tendency_prescriber: Optional[TendencyPrescriberConfig] = None
    online_emulator: Optional[Mapping[str, Any]] = None
    radiation_scheme: Optional[RadiationSchemeConfig] = None
    bias_correction: Optional[BiasCorrectionConfig] = None
    step_storage_variables: Sequence[str] = dataclasses.field(
        default_factory=list
    )
    step_tendency_variables: Sequence[str] = dataclasses.field(
        default_factory=list
    )


def get_config(config_dict: Mapping[str, Any]) -> UserConfig:
    """Extract the runtime keys (everything outside FV3CONFIG_KEYS) and
    deserialize strictly (config.py:76-95)."""
    runtime_keys = {
        k: v for k, v in config_dict.items() if k not in FV3CONFIG_KEYS
    }
    return from_dict(UserConfig, runtime_keys)


def load_config_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def get_namelist(config_dict: Mapping[str, Any]) -> Mapping[str, Any]:
    return config_dict.get("namelist", {})
