"""Emulation configuration (external/emulation/emulation/config.py
equivalents; a copy of the JAX package's ``emulation/config.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass
class ModelConfig:
    """Which model to run as the emulator and how to gate its outputs
    (config.py:77 ModelConfig)."""

    path: str = ""
    online: bool = True
    train: bool = False
    mask_kinds: Sequence[dict] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class StorageConfig:
    """Training-data capture settings (_monitor/monitor.py:26)."""

    output_freq_sec: int = 10800
    save_nc: bool = False
    save_zarr: bool = True
    var_meta_path: Optional[str] = None


@dataclasses.dataclass
class EmulationConfig:
    model: Optional[ModelConfig] = None
    gscond: Optional[ModelConfig] = None
    storage: Optional[StorageConfig] = None
