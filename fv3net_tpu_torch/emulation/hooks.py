"""Online-emulation hooks (external/emulation/emulation/__init__.py:18).

The reference injects keras microphysics emulators into the Fortran
physics driver via call_py_fort: the driver pushes a state dict, calls
``emulation.microphysics``, and reads back ``*_output`` keys
(README.md:9-24, _emulate/microphysics.py:50-110).  Here the physics is
already Python, so `get_hooks()` returns plain callables that the
wrapper's `apply_physics` invokes around its microphysics step -- same
contract, no language boundary.

A copy of the JAX package's ``emulation/hooks.py``: the hooks work on
host arrays, ``MicrophysicsHook`` loads its model through the port's
``fit.load`` (on the CUDA device unless the caller names another) and
``StorageHook`` writes through the port's ``io.zarr_lite``.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Callable, Mapping, Optional, Tuple

import numpy as np

from .config import EmulationConfig
from .masks import TimeMask

logger = logging.getLogger(__name__)


class MicrophysicsHook:
    """Run an emulator against the physics state
    (_emulate/microphysics.py:50): inputs are the ``*_input`` keys, the
    emulator writes ``*_output`` keys back into the state dict."""

    def __init__(self, model_path: str, masks=(),
                 time_mask: Optional[TimeMask] = None, device=None):
        from ..fit import load

        self.model = load(model_path, device)
        self.masks = list(masks)
        self.time_mask = time_mask

    def microphysics(self, state: dict) -> None:
        from ..util.quantity import Quantity

        inputs = {}
        for name in self.model.input_variables:
            key = name if name in state else f"{name}_input"
            arr = np.asarray(state[key])
            inputs[name] = Quantity(
                arr, ("tile", "z", "y", "x")[: arr.ndim], ""
            )
        prediction = self.model.predict(inputs)
        emulated = {k: np.asarray(v.data) for k, v in prediction.items()}
        for mask in self.masks:
            emulated = mask(state, emulated)
        if self.time_mask is not None:
            time = state.get("time", datetime.datetime(2000, 1, 1))
            emulated = self.time_mask(time, state, emulated)
        for key, arr in emulated.items():
            out_key = key if key.endswith("_output") else f"{key}_output"
            state[out_key] = arr


class StorageHook:
    """Capture physics states for training data
    (_monitor/monitor.py:195): periodically appends the pushed state to
    a zarr store."""

    def __init__(self, path: str, output_freq_sec: int = 10800,
                 dt_sec: int = 900):
        self.path = path
        self.output_freq_sec = output_freq_sec
        self.dt_sec = dt_sec
        self._calls = 0
        self._sink = None

    def store(self, state: Mapping) -> None:
        time_elapsed = self._calls * self.dt_sec
        self._calls += 1
        if time_elapsed % self.output_freq_sec != 0:
            return
        from ..io.zarr_lite import ZarrLiteStore

        if self._sink is None:
            os.makedirs(self.path, exist_ok=True)
            self._sink = ZarrLiteStore(
                os.path.join(self.path, "state_output.zarr")
            )
            self._init = set()
        for key, val in state.items():
            arr = np.asarray(val)
            if arr.dtype.kind not in "fiu":
                continue  # timestamps/strings are not training data
            arr = arr.astype(np.float32)
            if key not in self._init:
                self._sink.create_array(
                    key, shape=(0,) + arr.shape,
                    chunks=(1,) + arr.shape, dtype=np.float32,
                    dims=("time",) + tuple(
                        f"dim_{i}" for i in range(arr.ndim)
                    ),
                )
                self._init.add(key)
            self._sink.append(key, arr[None], axis=0)


def get_hooks(
    config: Optional[EmulationConfig] = None, device=None,
) -> Tuple[Callable, Callable, Callable]:
    """(gscond, microphysics, store) callables
    (emulation/__init__.py:18).  Without configuration they are no-ops,
    matching the reference's behavior when no emulator is configured.
    An emulator's model is loaded on `device` (the CUDA device unless the
    caller names one)."""
    config = config or EmulationConfig()

    def noop(state):
        return None

    gscond = noop
    microphysics = noop
    store = noop
    if config.gscond is not None and config.gscond.path:
        gscond = MicrophysicsHook(
            config.gscond.path, device=device
        ).microphysics
    if config.model is not None and config.model.path:
        microphysics = MicrophysicsHook(
            config.model.path, device=device
        ).microphysics
    if config.storage is not None:
        store = StorageHook(
            ".", output_freq_sec=config.storage.output_freq_sec
        ).store
    return gscond, microphysics, store
