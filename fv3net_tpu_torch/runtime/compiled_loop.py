"""The coupled time loop (the JAX package's ``runtime/compiled_loop.py``).

One coupled step composes the dycore's ``one_dt``, gray radiation, the
GFS physics suite (or the simple saturation adjustment), the ML
model's ``pure_fn``, the MSE-conserving humidity limiter, the NaN fill
with its filled-fraction diagnostics, the dry-mass-conserving humidity
and delp update, and the Monitor tendency/storage diagnostics.  The JAX
package jits the whole step into one dispatch; here it is a plain
function call of eager torch (a CUDA graph of it is later work, ROADMAP).

Per-substep semantics follow the reference's runtime/loop.py:
  - water_vapor_path before dynamics
  - Monitor(fv3_dynamics) around the dycore step
  - gray radiation heating
  - GFS physics suite + Monitor(fv3_physics)
  - ML postphysics: predict -> fillna (+ filled_frac diags) ->
    MSE-conserving limiter -> add tendency -> mass-conserving set ->
    Monitor(python)

Host work per step is the cos-zenith-angle field and the solar constant
(numpy, copied to the device once per step) and the datetime advance.
"""

from __future__ import annotations

import datetime
from typing import Mapping, Optional

import numpy as np
import torch

from ..constants import GRAV
from ..util.quantity import Quantity
from ..utils.zenith import cos_zenith_angle
from . import names
from .steppers import non_negative_sphum

DIMS_3D = ("tile", "z", "y", "x")
DIMS_2D = ("tile", "y", "x")

# ML outputs the compiled step applies; the other tendencies of
# names.TENDENCY_TO_STATE_NAME (winds, delp) raise at build time -- the
# JAX package fills and then drops them (ROADMAP fault note (e))
APPLIED_TENDENCIES = ("dQ1", "dQ2")


def _monitor(diags, label, before_t, before_q, delp_before,
             after_t, after_q, delp_after, dt):
    """Tendency + path-storage diagnostics of one monitored block
    (runtime/monitor.py:21-120)."""
    for v, b, a in (
        (names.TEMP, before_t, after_t),
        (names.SPHUM, before_q, after_q),
    ):
        tend = (a - b) / dt
        diags[f"tendency_of_{v}_due_to_{label}"] = tend
        diags[f"storage_of_{v}_path_due_to_{label}"] = (
            tend * delp_after / GRAV
        ).sum(dim=1)
    diags[f"storage_of_mass_due_to_{label}"] = (
        (delp_after - delp_before) / GRAV
    ).sum(dim=1) / dt
    return diags


# ML inputs the step supplies ("vertical_wind" only when the state has w)
ML_INPUTS = (
    names.TEMP, names.SPHUM, names.CLOUD, names.DELP, names.X_WIND,
    names.Y_WIND, "vertical_wind", "time",
)


def _check_ml_model(ml_model, has_w: bool):
    """Fail at build time for ML inputs the step cannot supply and for
    tendency outputs it would not apply."""
    for name in ml_model.input_variables:
        if name not in ML_INPUTS or (name == "vertical_wind" and not has_w):
            raise NotImplementedError(
                f"the compiled step cannot supply ML input {name!r}"
            )
    for name in ml_model.output_variables:
        if (
            name in names.TENDENCY_TO_STATE_NAME
            and name not in APPLIED_TENDENCIES
        ):
            raise NotImplementedError(
                f"the compiled step applies only {APPLIED_TENDENCIES}; "
                f"ML output {name!r} would be dropped"
            )


def build_compiled_step(mdl, ml_model=None, split: bool = False):
    """Build the coupled-step function from an initialized wrapper model
    (``fv3net_tpu_torch.wrapper.get_model()``).

    Returns
        step(state, phis, tsfc, total_precip, cosz, solcon)
          -> (state', total_precip', precip_rate, diags)
    with every tensor on the model's device (solcon a float).
    split=True also returns the three stage functions (dynamics,
    physics, postphysics) for per-stage timing.
    """
    from ..physics.gfs import MP_TRACER_NAMES, gfs_physics_step
    from ..wrapper import pressure_layers, pt_from_temperature, \
        temperature_from_pt

    cfg = mdl.config
    dt = cfg.dt_atmos
    ptop = cfg.ptop
    dtype = mdl.dtype
    one_dt = mdl.run_step.one_dt
    gfs_cfg = mdl.gfs_config
    rad = mdl._radiation
    if ml_model is not None:
        _check_ml_model(ml_model, mdl.state.w is not None)
        ml_params = ml_model.params_on(mdl.device)

    def temperature(st):
        return temperature_from_pt(st.delp, st.pt, st.q[0], ptop)

    def layer_pressure(delp):
        pe, _ = pressure_layers(delp, ptop)
        return 0.5 * (pe[:, 1:] + pe[:, :-1])

    # --- stage 1: monitored dynamics -----------------------------------
    def stage_dynamics(state, phis):
        diags = {
            "water_vapor_path": (state.q[0] * state.delp / GRAV).sum(dim=1)
        }
        t_b = temperature(state)
        st = one_dt(state, phis)
        _monitor(
            diags, "fv3_dynamics", t_b, state.q[0], state.delp,
            temperature(st), st.q[0], st.delp, dt,
        )
        return st, diags

    # --- stage 2: radiation + physics (monitored) ----------------------
    def stage_physics(st, tsfc, total_precip, cosz, solcon):
        diags = {}
        temp = temperature(st)
        qv, qc = st.q[0], st.q[1]
        if rad is not None:
            out = rad._core(
                cosz, layer_pressure(st.delp), st.delp, temp, qv, tsfc,
                solcon,
            )
            heating = (
                out["shortwave_heating_rate"] + out["longwave_heating_rate"]
            )
            temp = temp + heating * dt
            diags.update(out)
        t_b, q_b = temp, qv
        extra = []  # prognostic hydrometeors beyond (qv, qc)
        if cfg.physics_suite == "gfs":
            prognostic_mp = (
                st.q.shape[0] >= 6 and gfs_cfg.microphysics_scheme == "gfdl"
            )
            pout, pdiags = gfs_physics_step(
                temp, qv, qc, st.u, st.v, st.delp, tsfc, ptop, dt,
                cfg=gfs_cfg,
                mp_tracers=tuple(st.q[2:6]) if prognostic_mp else None,
            )
            temp = pout["air_temperature"]
            qv = pout["specific_humidity"]
            qc = pout["cloud_water_mixing_ratio"]
            if prognostic_mp:
                extra = [pout[k] for k in MP_TRACER_NAMES]
            st = st._replace(
                u=pout["u_dgrid"].to(dtype), v=pout["v_dgrid"].to(dtype)
            )
            precip = pdiags.pop("total_precipitation")
            diags.update(pdiags)
        elif cfg.physics_suite == "simple" and cfg.do_sat_adj:
            from ..physics.simple import saturation_adjustment

            temp, qv, qc, precip = saturation_adjustment(
                temp, qv, qc, layer_pressure(st.delp), st.delp, dt
            )
        else:
            precip = torch.zeros_like(tsfc)
        _monitor(
            diags, "fv3_physics", t_b, q_b, st.delp,
            temp, qv, st.delp, dt,
        )
        total_precip = total_precip + precip / 1000.0  # kg/m2 -> m
        precip_rate = precip / dt
        # tracers beyond the suite's prognostic set pass through unchanged
        q_new = torch.stack([qv, qc] + extra).to(dtype)
        q_new = torch.cat([q_new, st.q[q_new.shape[0]:]], dim=0)
        st = st._replace(
            pt=pt_from_temperature(st.delp, temp, qv, ptop).to(dtype),
            q=q_new,
        )
        return st, total_precip, precip_rate, diags

    # --- stage 3: ML postphysics (monitored, mass-conserving) ----------
    def _ml_inputs(st, temp, qv):
        fields = {
            names.TEMP: temp, names.SPHUM: qv, names.CLOUD: st.q[1],
            names.DELP: st.delp, names.X_WIND: st.u, names.Y_WIND: st.v,
            "vertical_wind": st.w,
        }
        return {
            name: fields[name]
            for name in ml_model.input_variables if name != "time"
        }

    def stage_postphysics(st):
        diags = {}
        if ml_model is None:
            return st, diags
        temp = temperature(st)
        qv, qc = st.q[0], st.q[1]
        preds = ml_model.pure_fn(ml_params, _ml_inputs(st, temp, qv))
        tend = {}
        for k in APPLIED_TENDENCIES:
            if k not in preds:
                continue
            isnan = torch.isnan(preds[k])
            tend[k] = torch.where(isnan, 0.0, preds[k])
            diags[f"{k}_filled_frac"] = isnan.to(preds[k].dtype).mean()
        dQ1 = tend.get("dQ1", torch.zeros_like(temp))
        dQ2 = tend.get("dQ2", torch.zeros_like(qv))
        dQ1, dQ2 = non_negative_sphum(qv, dQ1, dQ2, dt)
        t2 = temp + dQ1 * dt
        qv2 = qv + dQ2 * dt
        # dry-air-mass-conserving humidity set
        # (wrapper.set_state_mass_conserving semantics)
        delp2 = st.delp * (1.0 - qv) / (1.0 - qv2)
        _monitor(diags, "python", temp, qv, st.delp, t2, qv2, delp2, dt)
        st = st._replace(
            delp=delp2.to(dtype),
            pt=pt_from_temperature(delp2, t2, qv2, ptop).to(dtype),
            q=torch.cat(
                [torch.stack([qv2, qc]).to(dtype), st.q[2:]], dim=0
            ),
        )
        return st, diags

    def full_step(state, phis, tsfc, total_precip, cosz, solcon):
        st, d1 = stage_dynamics(state, phis)
        st, total_precip, precip_rate, d2 = stage_physics(
            st, tsfc, total_precip, cosz, solcon
        )
        st, d3 = stage_postphysics(st)
        return st, total_precip, precip_rate, {**d1, **d2, **d3}

    if not split:
        return full_step
    return full_step, {
        "dynamics": stage_dynamics,
        "physics": stage_physics,
        "postphysics": stage_postphysics,
    }


class CompiledTimeLoop:
    """TimeLoop over the coupled step: iterates (time, diagnostics)
    pairs (the reference TimeLoop contract, runtime/loop.py:239); the
    diagnostics are Quantities over device tensors, copied to the host
    only when a sink reads ``.values``."""

    def __init__(self, wrapper_module, ml_model=None,
                 n_steps: Optional[int] = None):
        from .timing import Timer

        self._wm = wrapper_module
        self.mdl = wrapper_module.get_model()
        self.n_steps = n_steps
        self._step_fn = build_compiled_step(self.mdl, ml_model)
        self._step_count = 0
        # constant surface fields staged to the device once: per-step
        # host work stays O(astronomy)
        self._tsfc = self._on_device(self.mdl.tsfc)
        self.timer = Timer()

    def _on_device(self, a):
        return torch.as_tensor(a, dtype=self.mdl.dtype, device=self.mdl.device)

    def _astronomy(self):
        """Solar inputs at the END time of the step: the eager loop
        advances the clock inside step_dynamics, so radiation sees
        time + dt_atmos."""
        mdl = self.mdl
        t_rad = mdl.time + datetime.timedelta(seconds=mdl.config.dt_atmos)
        if mdl._radiation is not None:
            mdl._radiation.radupdate(t_rad)
            solcon = float(mdl._radiation._solcon)
        else:
            solcon = 0.0
        cosz = np.maximum(
            cos_zenith_angle(t_rad, np.rad2deg(mdl.lon), np.rad2deg(mdl.lat)),
            0.0,
        )
        return self._on_device(cosz), solcon

    def step(self) -> Mapping[str, Quantity]:
        """Advance one dt_atmos; returns the diagnostics mapping."""
        mdl = self.mdl
        cosz, solcon = self._astronomy()
        with self.timer.clock("mainloop"):
            st, total_precip, precip_rate, diags = self._step_fn(
                mdl.state, mdl.phis, self._tsfc,
                self._on_device(mdl.total_precip), cosz, solcon,
            )
        mdl.state = st
        mdl.total_precip = total_precip
        mdl.precip_rate = precip_rate
        mdl.step_count += 1
        mdl.time = mdl.time + datetime.timedelta(seconds=mdl.config.dt_atmos)
        self._step_count += 1
        return {
            k: Quantity(
                v, DIMS_3D if v.ndim == 4 else DIMS_2D if v.ndim == 3 else (),
                "",
            )
            for k, v in diags.items()
        }

    def __iter__(self):
        while self.n_steps is None or self._step_count < self.n_steps:
            diags = self.step()
            yield self.mdl.time, diags

    def block(self):
        """Wait for the in-flight step (a data-dependent fetch)."""
        return float(self.mdl.state.delp[0, 0, 0, 0])
