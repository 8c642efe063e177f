"""The coupling time loop (the JAX package's ``runtime/loop.py``;
TimeLoop equivalent, the reference's runtime/loop.py:239).

Drives the wrapper through the reference's substep sequence:

    compute_column_integrated_tracers
    -> monitored step_dynamics
    -> prephysics steppers
    -> pre-radiation / radiation / post-radiation physics
    -> monitored apply_physics
    -> compute_postphysics (ML / nudging / bias correction)
    -> monitored apply_postphysics_to_dycore_state
    -> intermediate restarts

Steppers follow the reference protocol: callables returning
(tendencies, diagnostics, state_updates).  The model's fields are
tensors on its device; the monitors, the tendency application and the
NaN fill stay on that device (a tendency given as a host array is moved
there), so the loop adds no synchronisation of its own.
"""

from __future__ import annotations

import logging
from typing import (
    Callable,
    Iterable,
    Mapping,
    MutableMapping,
    Optional,
    Protocol,
    Tuple,
)

import numpy as np
import torch

from ..constants import GRAV
from ..util.quantity import Quantity
from . import names

logger = logging.getLogger(__name__)

State = MutableMapping[str, Quantity]
Diagnostics = Mapping[str, Quantity]
Tendencies = Mapping[str, Quantity]


class Stepper(Protocol):
    """The stepper contract (the reference's runtime/loop.py:65-88)."""

    @property
    def label(self) -> str:
        ...

    def __call__(
        self, time, state
    ) -> Tuple[Tendencies, Diagnostics, Mapping[str, Quantity]]:
        ...

    def get_diagnostics(
        self, state, tendency
    ) -> Tuple[Diagnostics, Quantity]:
        ...


def _like(x, ref):
    """x on ref's side: a tensor on ref's device where ref is a tensor
    (x keeps its dtype), else a host array."""
    if isinstance(ref, torch.Tensor):
        return torch.as_tensor(x, device=ref.device)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def add_tendency(state, tendencies: Tendencies, dt: float) -> State:
    """Apply tendency dict entries named per TENDENCY_TO_STATE_NAME,
    returning the updated variables (not applied to the model yet).
    Stays on the state's device."""
    updated = {}
    for tname, tq in tendencies.items():
        if tname not in names.TENDENCY_TO_STATE_NAME:
            continue
        sname = names.TENDENCY_TO_STATE_NAME[tname]
        current = state[sname]
        data = current.data + _like(tq.data, current.data) * dt
        clean = (
            torch.nan_to_num(data) if isinstance(data, torch.Tensor)
            else np.nan_to_num(data)
        )
        updated[sname] = current.with_data(clean)
    return updated


def fillna_tendencies(tendencies: Tendencies):
    """NaN-fill with filled-fraction diagnostics (the reference's
    runtime/loop.py:103-123)."""
    filled = {}
    diags = {}
    for name, q in tendencies.items():
        arr = q.data
        if isinstance(arr, torch.Tensor):
            isnan = torch.isnan(arr)
            filled[name] = q.with_data(torch.where(isnan, 0.0, arr))
            frac = isnan.to(arr.dtype).mean()
        else:
            isnan = np.isnan(arr)
            filled[name] = q.with_data(np.where(isnan, 0.0, arr))
            frac = np.asarray(isnan.mean())
        diags[f"{name}_filled_frac"] = Quantity(frac, (), "")
    return filled, diags


class Monitor:
    """Wrap a step function; emit tendency_of_<X>_due_to_<name> and path
    (column-integral) storages by checkpointing state before/after."""

    def __init__(self, name: str, state, variables: Iterable[str],
                 dt: float):
        self.name = name
        self.state = state
        self.variables = list(variables)
        self.dt = dt

    def __call__(self, step: Callable[[], Diagnostics]):
        def wrapped() -> Diagnostics:
            # raw .data: device state stays on the device; a sink copies
            # to the host when it reads .values
            before = {v: self.state[v].data for v in self.variables}
            delp_before = self.state[names.DELP].data
            diags = dict(step() or {})
            delp_after = self.state[names.DELP].data
            for v in self.variables:
                after = self.state[v].data
                tend = (after - before[v]) / self.dt
                key = f"tendency_of_{v}_due_to_{self.name}"
                diags[key] = Quantity(tend, ("tile", "z", "y", "x"), "")
                path = (tend * delp_after / GRAV).sum(1)
                diags[
                    f"storage_of_{v}_path_due_to_{self.name}"
                ] = Quantity(path, ("tile", "y", "x"), "")
            mass_storage = (
                (delp_after - delp_before) / GRAV
            ).sum(1) / self.dt
            diags[
                f"storage_of_mass_due_to_{self.name}"
            ] = Quantity(mass_storage, ("tile", "y", "x"), "kg/m**2/s")
            return diags

        return wrapped


class TimeLoop:
    """Iterate (time, diagnostics) pairs, one model step each."""

    def __init__(
        self,
        wrapper,
        state,
        dt: float,
        prephysics_steppers: Optional[Iterable[Stepper]] = None,
        postphysics_stepper: Optional[Stepper] = None,
        radiation_stepper: Optional[Stepper] = None,
        n_steps: Optional[int] = None,
        monitored_variables: Iterable[str] = (
            names.TEMP,
            names.SPHUM,
        ),
        tendency_variables: Mapping[str, str] = None,
    ):
        from .timing import Timer

        self.wrapper = wrapper
        self.state = state
        self.dt = dt
        self.prephysics_steppers = list(prephysics_steppers or [])
        self.postphysics_stepper = postphysics_stepper
        self.radiation_stepper = radiation_stepper
        self.n_steps = n_steps
        self.monitored = list(monitored_variables)
        self._step_count = 0
        # per-substep wall clock on the host (the reference's
        # runtime/loop.py:272,681): it measures enqueue time unless the
        # caller synchronises before reading it
        self.timer = Timer()

    # --- substeps ---------------------------------------------------------

    def _compute_column_integrated_tracers(self) -> Diagnostics:
        delp = self.state[names.DELP].data
        q = self.state[names.SPHUM].data
        wp = (q * delp / GRAV).sum(1)
        return {
            "water_vapor_path": Quantity(wp, ("tile", "y", "x"),
                                         "kg/m**2")
        }

    def _step_dynamics(self) -> Diagnostics:
        mon = Monitor("fv3_dynamics", self.state, self.monitored, self.dt)
        return mon(lambda: self.wrapper.step_dynamics() or {})()

    def _step_prephysics(self) -> Diagnostics:
        diags = {}
        for stepper in self.prephysics_steppers:
            _, d, updates = stepper(self.state.time, self.state)
            diags.update(d)
            if updates:
                self.state.update_mass_conserving(updates)
        return diags

    def _step_physics(self) -> Diagnostics:
        self.wrapper.step_pre_radiation()
        diags = {}
        if self.radiation_stepper is not None:
            tendencies, d, updates = self.radiation_stepper(
                self.state.time, self.state
            )
            diags.update(d)
            if tendencies:
                updated = add_tendency(self.state, tendencies, self.dt)
                self.state.update_mass_conserving(updated)
            if updates:
                self.state.update_mass_conserving(updates)
        self.wrapper.step_radiation()
        self.wrapper.step_post_radiation_physics()
        mon = Monitor("fv3_physics", self.state, self.monitored, self.dt)
        diags.update(mon(lambda: self.wrapper.apply_physics() or {})())
        return diags

    def _step_postphysics(self) -> Diagnostics:
        if self.postphysics_stepper is None:
            return {}
        tendencies, diags, updates = self.postphysics_stepper(
            self.state.time, self.state
        )
        tendencies, fill_diags = fillna_tendencies(tendencies)
        diags = dict(diags)
        diags.update(fill_diags)
        mon = Monitor("python", self.state, self.monitored, self.dt)

        def apply():
            updated = add_tendency(self.state, tendencies, self.dt)
            self.state.update_mass_conserving(updated)
            if updates:
                self.state.update_mass_conserving(updates)
            return {}

        diags.update(mon(apply)())
        return diags

    # --- iteration --------------------------------------------------------

    def __iter__(self):
        substeps = (
            ("tracers", self._compute_column_integrated_tracers),
            ("dynamics", self._step_dynamics),
            ("prephysics", self._step_prephysics),
            ("physics", self._step_physics),
            ("postphysics", self._step_postphysics),
        )
        while self.n_steps is None or self._step_count < self.n_steps:
            diags = {}
            with self.timer.clock("mainloop"):
                for name, substep in substeps:
                    with self.timer.clock(name):
                        diags.update(substep())
                self.wrapper.save_intermediate_restart_if_enabled()
            self._step_count += 1
            yield self.state.time, diags

    def log_timings(self):
        """min/max/mean per substep (the reference's log_global_timings,
        runtime/loop.py:516-543)."""
        from .timing import timing_report

        report = timing_report(self.timer)
        logger.info("timing report: %s", report)
        return report
