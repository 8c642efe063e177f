"""Steppers: ML tendencies, nudging, prescribers, combinations (the JAX
package's ``runtime/steppers.py``).

The semantics of the reference's runtime/steppers/ package:
PureMLStepper (machine_learning.py:214), RenamingAdapter /
MultiModelAdapter (:106,150), the MSE-conserving humidity limiter
(:67-101), PureNudger (nudging.py:16), Prescriber (prescriber.py:50),
CombinedStepper (combine.py:28), and TendencyPrescriber
(transformers/tendency_prescriber.py:42).  The ML stepper's limiter runs
on the state's device; the nudger and the prescribers read their
reference data on the host (``.values``), as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..constants import CP_AIR, LATENT_HEAT_VAPORIZATION as LV
from ..util.quantity import Quantity
from . import names

SPHUM = names.SPHUM
TEMP = names.TEMP


def non_negative_sphum(sphum, dQ1, dQ2, dt: float):
    """Moist-static-energy-conserving humidity limiter: where the
    predicted dQ2 would drive humidity negative, reduce it and compensate
    dQ1 so cp*dQ1 + Lv*dQ2 is unchanged.  Tensors on one device."""
    delta = dQ2 * dt
    reduction_ratio = torch.where(
        (delta < 0) & (sphum + delta < 0),
        torch.clip(
            -sphum / torch.where(delta != 0, delta, torch.ones_like(delta)),
            0.0, 1.0,
        ),
        1.0,
    )
    dQ2_limited = dQ2 * reduction_ratio
    dQ1_limited = dQ1 + (LV / CP_AIR) * (dQ2 - dQ2_limited)
    return dQ1_limited, dQ2_limited


class RenamingAdapter:
    """Rename state/prediction variables around a model
    (machine_learning.py:106)."""

    def __init__(self, model, rename_in: Mapping[str, str],
                 rename_out: Optional[Mapping[str, str]] = None):
        self.model = model
        self.rename_in = dict(rename_in)
        self.rename_out = dict(rename_out or {})

    @property
    def input_variables(self):
        inv = {v: k for k, v in self.rename_in.items()}
        return [inv.get(v, v) for v in self.model.input_variables]

    def predict(self, state):
        renamed = {
            self.rename_in.get(k, k): v for k, v in state.items()
        }
        out = self.model.predict(renamed)
        return {self.rename_out.get(k, k): v for k, v in out.items()}


class MultiModelAdapter:
    """Concatenate predictions of several models
    (machine_learning.py:150)."""

    def __init__(self, models: Sequence):
        self.models = list(models)

    @property
    def input_variables(self):
        out = []
        for m in self.models:
            out.extend(m.input_variables)
        return sorted(set(out))

    def predict(self, state):
        out = {}
        for m in self.models:
            out.update(m.predict(state))
        return out


@dataclasses.dataclass
class MachineLearningConfig:
    """(machine_learning.py:25)"""

    url: Sequence[str] = ()
    diagnostic_ml: bool = False
    input_standard_names: Mapping[str, str] = dataclasses.field(
        default_factory=dict
    )
    output_standard_names: Mapping[str, str] = dataclasses.field(
        default_factory=dict
    )
    use_mse_conserving_humidity_limiter: bool = True


class PureMLStepper:
    """Apply an ML model's predicted tendencies
    (machine_learning.py:214)."""

    label = "machine_learning"

    def __init__(self, model, dt: float, hydrostatic: bool = True,
                 mse_conserving_limiter: bool = True,
                 diagnostic_only: bool = False):
        self.model = model
        self.dt = dt
        self.mse_conserving_limiter = mse_conserving_limiter
        self.diagnostic_only = diagnostic_only

    def __call__(self, time, state):
        inputs = {
            k: state[k] for k in self.model.input_variables
            if k != "time"
        }
        prediction = self.model.predict(inputs)
        tendencies = {}
        state_updates = {}
        for key, q in prediction.items():
            if names.is_tendency_variable(key):
                tendencies[key] = q
            else:
                state_updates[key] = q
        if (
            self.mse_conserving_limiter
            and "dQ1" in tendencies
            and "dQ2" in tendencies
        ):
            # on the humidity's device; a prediction given as a host
            # array is moved there and keeps its dtype
            sphum = state[SPHUM].data
            dq1, dq2 = non_negative_sphum(
                sphum,
                *(torch.as_tensor(tendencies[k].data, device=sphum.device)
                  for k in ("dQ1", "dQ2")),
                dt=self.dt,
            )
            tendencies["dQ1"] = tendencies["dQ1"].with_data(dq1)
            tendencies["dQ2"] = tendencies["dQ2"].with_data(dq2)
        diags = {}
        if self.diagnostic_only:
            diags = {
                f"{k}_diagnostic": v for k, v in tendencies.items()
            }
            return {}, diags, {}
        return tendencies, diags, state_updates

    def get_diagnostics(self, state, tendency):
        return {}, Quantity(np.zeros(()), (), "")


@dataclasses.dataclass
class NudgingConfig:
    """Per-variable nudging timescales in hours (nudging.py:29)."""

    timescale_hours: Mapping[str, float] = dataclasses.field(
        default_factory=dict
    )
    restarts_path: str = ""


class PureNudger:
    """(reference - state)/tau tendencies (steppers/nudging.py:16,
    runtime/nudging.py:180)."""

    label = "nudging"

    def __init__(self, config: NudgingConfig, get_reference_state):
        self.config = config
        self.get_reference_state = get_reference_state

    def __call__(self, time, state):
        reference = self.get_reference_state(time)
        tendencies = {}
        diags = {}
        for var, hours in self.config.timescale_hours.items():
            tau = hours * 3600.0
            ref = reference[var]
            tend = (ref.values - state[var].values) / tau
            tname = names.STATE_NAME_TO_TENDENCY.get(
                var, f"{var}_tendency_due_to_nudging"
            )
            tendencies[tname] = Quantity(tend, ref.dims, "")
            # the nudged-to-fine training-data convention consumed by
            # open_nudge_to_fine (loaders _nudged.py:118)
            diags[f"{var}_tendency_due_to_nudging"] = Quantity(
                tend, ref.dims, ""
            )
        return tendencies, diags, {}

    def get_diagnostics(self, state, tendency):
        return {}, Quantity(np.zeros(()), (), "")


@dataclasses.dataclass
class PrescriberConfig:
    """(prescriber.py)"""

    dataset_key: str = ""
    variables: Sequence[str] = ()
    reference_initial_time: Optional[str] = None
    reference_frequency_seconds: float = 900.0


class Prescriber:
    """Overwrite state variables from a time-indexed external dataset
    (steppers/prescriber.py:50); includes the SST-masking behavior of
    sst_update_from_reference (:129)."""

    label = "prescriber"

    def __init__(self, config: PrescriberConfig, get_prescribed_state):
        self.config = config
        self.get_prescribed = get_prescribed_state

    def __call__(self, time, state):
        prescribed = self.get_prescribed(time)
        state_updates = {}
        for var in self.config.variables:
            q = prescribed[var]
            if var == names.TSFC and names.MASK in state.keys():
                # only update open-ocean points (prescriber.py:129)
                mask = state[names.MASK].values
                current = state[var].values
                data = np.where(np.isclose(mask, 0.0), q.values, current)
                q = q.with_data(data)
            state_updates[var] = q
        return {}, {}, state_updates

    def get_diagnostics(self, state, tendency):
        return {}, Quantity(np.zeros(()), (), "")


class CombinedStepper:
    """Merge several steppers, raising on output collisions
    (steppers/combine.py:28)."""

    def __init__(self, steppers: Sequence):
        self.steppers = list(steppers)

    @property
    def label(self):
        return "+".join(s.label for s in self.steppers)

    def __call__(self, time, state):
        tendencies = {}
        diags = {}
        updates = {}
        for stepper in self.steppers:
            t, d, u = stepper(time, state)
            for out, new in ((tendencies, t), (diags, d), (updates, u)):
                for k in new:
                    if k in out:
                        raise ValueError(
                            f"stepper output collision on {k!r}"
                        )
                out.update(new)
        return tendencies, diags, updates

    def get_diagnostics(self, state, tendency):
        return {}, Quantity(np.zeros(()), (), "")


@dataclasses.dataclass
class TendencyPrescriberConfig:
    variables: Mapping[str, str] = dataclasses.field(default_factory=dict)


class TendencyPrescriber:
    """Replace physics tendencies of selected variables with values from
    a dataset (transformers/tendency_prescriber.py:42): wraps a step
    function, subtracting the model's tendency and adding the
    prescribed one."""

    def __init__(self, config: TendencyPrescriberConfig, state, dt: float,
                 get_prescribed_tendencies):
        self.config = config
        self.state = state
        self.dt = dt
        self.get_prescribed = get_prescribed_tendencies

    def __call__(self, step):
        def wrapped():
            before = {
                var: self.state[var].values
                for var in self.config.variables
            }
            diags = dict(step() or {})
            prescribed = self.get_prescribed(self.state.time)
            for var, source_name in self.config.variables.items():
                tq = prescribed[source_name]
                new = before[var] + tq.values * self.dt
                self.state[var] = self.state[var].with_data(new)
                diags[
                    f"tendency_of_{var}_due_to_tendency_prescriber"
                ] = tq
            return diags

        return wrapped
