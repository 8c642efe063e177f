"""Emulator output masks and blending schedules
(external/emulation/emulation/masks.py and
_emulate/microphysics.py:23-47 equivalents; a copy of the JAX
package's ``emulation/masks.py``)."""

from __future__ import annotations

import dataclasses
import datetime
from typing import Mapping, Optional

import numpy as np


@dataclasses.dataclass
class RangeMask:
    """Clip an emulated field into [min, max] (masks.py RangeMask)."""

    key: str
    min: Optional[float] = None
    max: Optional[float] = None

    def __call__(self, state: Mapping, emulated: Mapping) -> Mapping:
        out = dict(emulated)
        if self.key in out:
            arr = np.asarray(out[self.key])
            if self.min is not None:
                arr = np.maximum(arr, self.min)
            if self.max is not None:
                arr = np.minimum(arr, self.max)
            out[self.key] = arr
        return out


@dataclasses.dataclass
class LevelMask:
    """Use the physics value instead of the emulator above/below given
    levels (masks.py LevelMask)."""

    key: str
    start: Optional[int] = None
    stop: Optional[int] = None
    fill_value_key: Optional[str] = None

    def __call__(self, state: Mapping, emulated: Mapping) -> Mapping:
        out = dict(emulated)
        if self.key in out and self.fill_value_key in state:
            arr = np.array(out[self.key])
            fill = np.asarray(state[self.fill_value_key])
            sl = slice(self.start, self.stop)
            arr[..., sl, :, :] = fill[..., sl, :, :] if arr.ndim >= 3 \
                else fill[sl]
            out[self.key] = arr
        return out


@dataclasses.dataclass
class IntervalSchedule:
    """Alternate emulator/physics on a time interval
    (_emulate/microphysics.py:23): weight 1 within the first `period`
    fraction of each cycle."""

    period: datetime.timedelta = datetime.timedelta(hours=3)
    initial_time: datetime.datetime = datetime.datetime(2000, 1, 1)

    def __call__(self, time: datetime.datetime) -> float:
        elapsed = (time - self.initial_time).total_seconds()
        half = self.period.total_seconds()
        return 1.0 if (elapsed % (2 * half)) < half else 0.0


@dataclasses.dataclass
class TimeMask:
    """Blend emulator and physics outputs by a time-dependent weight
    (_emulate/microphysics.py:35)."""

    schedule: IntervalSchedule = dataclasses.field(
        default_factory=IntervalSchedule
    )

    def __call__(self, time, state: Mapping,
                 emulated: Mapping) -> Mapping:
        alpha = self.schedule(time)
        out = {}
        for key, em in emulated.items():
            if key in state:
                out[key] = alpha * np.asarray(em) + (
                    1.0 - alpha
                ) * np.asarray(state[key])
            else:
                out[key] = em
        return out
