"""Online emulation of the microphysics (the JAX package's ``emulation/``):
hooks, masks, configuration and physics-space transforms."""

from .hooks import get_hooks, MicrophysicsHook, StorageHook
from .masks import RangeMask, LevelMask, TimeMask, IntervalSchedule
from .config import EmulationConfig, ModelConfig, StorageConfig

__all__ = [
    "get_hooks",
    "MicrophysicsHook",
    "StorageHook",
    "RangeMask",
    "LevelMask",
    "TimeMask",
    "IntervalSchedule",
    "EmulationConfig",
    "ModelConfig",
    "StorageConfig",
]
