"""Diagnostics output manager (runtime/diagnostics/manager.py, time.py;
a copy of the JAX package's ``runtime/diagnostics.py``).

DiagnosticFile selects variables and times and streams them to a sink;
the zarr-lite sink appends each step's selected fields along a time
dimension in a zarr-v2-compatible store (the reference uses
pace.util.ZarrMonitor, manager.py:82-96).  Time selection mirrors
All/IntervalTimes/SelectedTimes (time.py:16-126).
"""

from __future__ import annotations

import datetime
from typing import Mapping, Optional, Sequence

import numpy as np

from ..io.zarr_lite import ZarrLiteStore
from ..util.quantity import Quantity
from .config import DiagnosticFileConfig, TimeConfig


class All:
    def __contains__(self, time) -> bool:
        return True


class SelectedTimes:
    TIME_FMT = "%Y%m%d.%H%M%S"

    def __init__(self, times: Sequence[str]):
        self._times = {
            datetime.datetime.strptime(t, self.TIME_FMT) for t in times
        }

    def __contains__(self, time) -> bool:
        return time in self._times


class IntervalTimes:
    def __init__(self, frequency_seconds: float,
                 initial_time: Optional[datetime.datetime] = None):
        self.frequency = frequency_seconds
        self.initial_time = initial_time

    def __contains__(self, time) -> bool:
        if self.initial_time is None:
            ref = datetime.datetime(time.year, 1, 1)
        else:
            ref = self.initial_time
        elapsed = (time - ref).total_seconds()
        # tolerant modulo: float frequencies that don't divide dt
        # exactly must still select the nearest multiple (the reference
        # uses exact timedelta arithmetic; a strict `% == 0` is brittle)
        rem = elapsed % self.frequency
        tol = 1e-6 * max(1.0, abs(elapsed))
        return rem <= tol or (self.frequency - rem) <= tol


def time_container(config: TimeConfig):
    if config.kind == "every":
        return All()
    if config.kind == "interval":
        return IntervalTimes(config.frequency or 900.0)
    if config.kind == "selected":
        return SelectedTimes(config.times)
    raise ValueError(f"unknown time selection kind {config.kind!r}")


class ZarrSink:
    """Append-along-time sink writing zarr-lite stores."""

    def __init__(self, path: str):
        self.store = ZarrLiteStore(path)
        self._initialized = set()
        self._n_times = 0

    def sink(self, time, data: Mapping[str, Quantity]):
        for name, q in data.items():
            arr = np.asarray(q.values)
            if name not in self._initialized:
                self.store.create_array(
                    name,
                    shape=(0,) + arr.shape,
                    chunks=(1,) + arr.shape,
                    dtype=arr.dtype if arr.dtype != np.float64
                    else np.dtype("float32"),
                    dims=("time",) + tuple(q.dims),
                    attrs={"units": q.units},
                )
                self._initialized.add(name)
            self.store.append(
                name, arr[None].astype(np.float32, copy=False), axis=0
            )
        if "time" not in self._initialized:
            self.store.create_array(
                "time", shape=(0,), chunks=(1,), dtype=np.float64,
                dims=("time",),
                attrs={"units": "seconds since 1970-01-01"},
            )
            self._initialized.add("time")
        self.store.append(
            "time",
            np.array([time.timestamp()
                      if hasattr(time, "timestamp") else float(time)]),
            axis=0,
        )


class DiagnosticFile:
    """One output stream: variable selection + time selection + sink
    (manager.py:27)."""

    def __init__(self, config: DiagnosticFileConfig, run_dir: str):
        self.config = config
        self.times = time_container(config.times)
        self.sink = ZarrSink(f"{run_dir}/{config.name}")

    def observe(self, time, diagnostics: Mapping[str, Quantity]):
        if time not in self.times:
            return
        selected = {
            k: v for k, v in diagnostics.items()
            if not self.config.variables or k in self.config.variables
        }
        if selected:
            self.sink.sink(time, selected)


def get_diagnostic_files(
    configs: Sequence[DiagnosticFileConfig], run_dir: str
):
    return [DiagnosticFile(c, run_dir) for c in configs]
