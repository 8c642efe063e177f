"""Nudged-run reference-state plumbing (SURVEY 3.3, the
training-data-generation call stack).

Mirrors the reference's `setup_get_reference_state` +
`_get_reference_state` + linear time interpolation
(workflows/prognostic_c48_run/runtime/nudging.py:80-133,
runtime/interpolate.py:18-63): a directory of time-labeled
coarsened-restart snapshots (``<path>/<YYYYMMDD.HHMMSS>/*.tile?.nc``,
the layout produced by the coarsening pipeline and by
io.restarts.write_restarts) becomes a ``get_reference_state(time)``
callable that PureNudger consumes.  Between snapshots the reference
state is interpolated linearly in time (interpolate.py:18-63); the two
bracketing snapshots are LRU-cached so advancing model time re-reads
only one new snapshot per interval.

A copy of the JAX package's ``runtime/nudging.py``: the snapshots are
read and interpolated on the host (numpy), and the port's PureNudger
takes the difference from the model's state on the host, as the JAX
package's does; the loop moves the tendencies to the state's device.
"""

from __future__ import annotations

import datetime
import functools
import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from ..io.restarts import open_restarts
from ..util.quantity import Quantity
from .steppers import NudgingConfig, PureNudger

TIME_FMT = "%Y%m%d.%H%M%S"

# restart-file variable names -> runtime state names (the subset the
# reference nudges; runtime/names.py state vocabulary)
RESTART_TO_STATE_NAME = {
    "T": "air_temperature",
    "sphum": "specific_humidity",
    "delp": "pressure_thickness_of_atmospheric_layer",
    "u": "x_wind",
    "v": "y_wind",
    "W": "vertical_wind",
    "DZ": "vertical_thickness_of_atmospheric_layer",
    "liq_wat": "cloud_water_mixing_ratio",
    "ice_wat": "cloud_ice_mixing_ratio",
}


def label_to_time(label: str) -> datetime.datetime:
    """(interpolate.py:66-70)"""
    return datetime.datetime.strptime(label, TIME_FMT)


def time_to_label(time: datetime.datetime) -> str:
    return time.strftime(TIME_FMT)


def _snapshot_labels(path: str):
    labels = []
    for entry in sorted(os.listdir(path)):
        if not os.path.isdir(os.path.join(path, entry)):
            continue
        try:
            label_to_time(entry)
        except ValueError:
            continue
        labels.append(entry)
    if not labels:
        raise FileNotFoundError(
            f"no {TIME_FMT!r}-labeled snapshot directories under {path}"
        )
    return labels


def _open_snapshot(
    path: str, variables: Optional[Sequence[str]]
) -> Dict[str, Quantity]:
    """Open one snapshot dir and rename restart variables to runtime
    state names (_get_reference_state, nudging.py:111-133)."""
    opened = open_restarts(path)
    merged: Dict[str, Quantity] = {}
    for pfx in sorted(opened):
        merged.update(opened[pfx])
    out = {}
    for raw, q in merged.items():
        name = RESTART_TO_STATE_NAME.get(raw, raw)
        if variables is not None and name not in variables:
            continue
        out[name] = q
    if variables is not None:
        missing = set(variables) - set(out)
        if missing:
            raise KeyError(
                f"reference snapshot {path} lacks variables {sorted(missing)}"
            )
    return out


def setup_get_reference_state(
    config: NudgingConfig,
    variables: Optional[Sequence[str]] = None,
):
    """Build ``get_reference_state(time) -> {name: Quantity}`` from the
    snapshot directory tree at ``config.restarts_path``
    (nudging.py:80-108 + time_interpolate_func, interpolate.py:18-63).

    Linear interpolation between the two bracketing snapshots; exact
    snapshot times return the stored state untouched.  Times outside
    the covered interval raise (a nudged run must not silently
    extrapolate its training targets).
    """
    base = config.restarts_path
    labels = _snapshot_labels(base)
    times = [label_to_time(lbl) for lbl in labels]
    if variables is None and config.timescale_hours:
        variables = list(config.timescale_hours)

    @functools.lru_cache(maxsize=4)
    def _load(label: str) -> Mapping[str, Quantity]:
        return _open_snapshot(os.path.join(base, label), variables)

    def get_reference_state(time: datetime.datetime):
        if time < times[0] or time > times[-1]:
            raise ValueError(
                f"time {time} outside reference range "
                f"[{times[0]}, {times[-1]}]"
            )
        # bracketing snapshots
        import bisect

        i = bisect.bisect_left(times, time)
        if i < len(times) and times[i] == time:
            return dict(_load(labels[i]))
        t0, t1 = times[i - 1], times[i]
        w = (time - t0).total_seconds() / (t1 - t0).total_seconds()
        s0, s1 = _load(labels[i - 1]), _load(labels[i])
        out = {}
        for name, q0 in s0.items():
            q1 = s1[name]
            data = (1.0 - w) * np.asarray(q0.data) + w * np.asarray(
                q1.data
            )
            out[name] = Quantity(data, q0.dims, q0.units)
        return out

    return get_reference_state


def nudger_from_config(
    config: NudgingConfig,
    variables: Optional[Sequence[str]] = None,
) -> PureNudger:
    """The fully-wired nudged-run stepper: PureNudger driven by the
    snapshot-directory reference (stepper factory position,
    runtime/loop.py:373-443)."""
    return PureNudger(config, setup_get_reference_state(config, variables))
