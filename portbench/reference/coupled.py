"""fv3net's ML-corrected coupled step, plain torch.

A frozen copy of the plain form of the port's coupled step
(``fv3net_tpu_torch/runtime/compiled_loop.py`` ``build_compiled_step``,
its ``CompiledTimeLoop`` astronomy, and the wrapper's conversions
between temperature and virtual potential temperature), composed in the
program's order:

1. dynamics: the water vapour path, the dycore's dt (``hydro.py``) and
   the ``fv3_dynamics`` Monitor;
2. physics: gray radiation's heating, the GFS-style suite
   (``physics.py``) and the ``fv3_physics`` Monitor; the accumulated
   precipitation (m) and the step's rate;
3. postphysics: the dense corrector's dQ1 and dQ2 (``DenseCorrector``,
   read straight from the artifact fv3fit's dense family dumps), the NaN
   fill, the moist-static-energy-conserving humidity limiter
   (``non_negative_sphum``), the dry-mass-conserving set of delp, pt and
   humidity, and the ``python`` Monitor.

Departures from the program:

* no capture, no donation and no device spans: the step returns new
  tensors;
* the solar inputs are computed here from the step's start time (the
  program's loop computes them before the step, on the host, from the
  same time): cos zenith by a copy of ``utils/zenith.py`` on this
  grid's latitudes and longitudes, the solar constant by
  ``radupdate``'s formula;
* the corrector's MLP is ``torch.nn.functional.linear`` over the
  artifact's flax kernels, transposed into ``nn.Linear``'s layout, where
  the program runs an ``nn.Module`` of ``nn.Linear`` layers loaded from
  the same numbers;
* ``diags`` holds the suite's ``sas_fired`` mask besides the program's
  diagnostics.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from . import hydro
from .constants import (
    CP_AIR,
    GRAV,
    KAPPA,
    LATENT_HEAT_VAPORIZATION,
    REFERENCE_SURFACE_PRESSURE,
    ZVIR,
)
from .geometry import CubedSphereGrid
from .physics import (
    MP_TRACER_NAMES,
    gfs_physics_step,
    gray_radiation,
    solar_constant,
)


# --- conversions (the wrapper's) ---------------------------------------------

def pressure_layers(delp, ptop):
    """(pe, pi_lay): interface pressures and the hydrostatically
    consistent layer-mean Exner function."""
    pe = ptop + torch.cat(
        [torch.zeros_like(delp[:, :1]), torch.cumsum(delp, dim=1)], dim=1
    )
    pik = (pe / REFERENCE_SURFACE_PRESSURE) ** KAPPA
    pi_lay = (
        pik[:, 1:] * pe[:, 1:] - pik[:, :-1] * pe[:, :-1]
    ) / ((1.0 + KAPPA) * delp)
    return pe, pi_lay


def temperature_from_pt(delp, pt, qv, ptop):
    _, pi = pressure_layers(delp, ptop)
    return pt * pi / (1.0 + ZVIR * qv)


def pt_from_temperature(delp, temp, qv, ptop):
    _, pi = pressure_layers(delp, ptop)
    return temp * (1.0 + ZVIR * qv) / pi


def layer_pressure(delp, ptop):
    pe, _ = pressure_layers(delp, ptop)
    return 0.5 * (pe[:, 1:] + pe[:, :-1])


# --- astronomy (utils/zenith.py) ---------------------------------------------

def _days_from_2000(time: datetime.datetime) -> float:
    ref = datetime.datetime(2000, 1, 1, 12, 0, 0)
    return (time - ref).total_seconds() / 86400.0


def cos_zenith_angle(time: datetime.datetime, lon_deg, lat_deg):
    """Cosine of the solar zenith angle at `time` (numpy, degrees in)."""
    lon = np.deg2rad(np.asarray(lon_deg))
    lat = np.deg2rad(np.asarray(lat_deg))
    jd = _days_from_2000(time)
    g = np.deg2rad((357.529 + 0.98560028 * jd) % 360.0)
    q = (280.459 + 0.98564736 * jd) % 360.0
    lam = np.deg2rad(
        (q + 1.915 * np.sin(g) + 0.020 * np.sin(2 * g)) % 360.0
    )
    e = np.deg2rad(23.439 - 0.00000036 * jd)
    dec = np.arcsin(np.sin(e) * np.sin(lam))
    ra = np.arctan2(np.cos(e) * np.sin(lam), np.cos(lam))
    gmst = np.deg2rad((280.46061837 + 360.98564736629 * jd) % 360.0)
    hour_angle = gmst + lon - ra
    return np.sin(lat) * np.sin(dec) + np.cos(lat) * np.cos(dec) * np.cos(
        hour_angle
    )


# --- the corrector's limiter and Monitors ------------------------------------

def non_negative_sphum(sphum, dQ1, dQ2, dt: float):
    """Where dQ2 would drive humidity negative, reduce it and compensate
    dQ1 so that cp dQ1 + Lv dQ2 is unchanged."""
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
    dQ1_limited = dQ1 + (LATENT_HEAT_VAPORIZATION / CP_AIR) * (
        dQ2 - dQ2_limited)
    return dQ1_limited, dQ2_limited


def monitor(diags, label, before_t, before_q, delp_before,
            after_t, after_q, delp_after, dt):
    """The tendency and path-storage diagnostics of one monitored
    block."""
    for v, b, a in (("air_temperature", before_t, after_t),
                    ("specific_humidity", before_q, after_q)):
        tend = (a - b) / dt
        diags[f"tendency_of_{v}_due_to_{label}"] = tend
        diags[f"storage_of_{v}_path_due_to_{label}"] = (
            tend * delp_after / GRAV
        ).sum(dim=1)
    diags[f"storage_of_mass_due_to_{label}"] = (
        (delp_after - delp_before) / GRAV
    ).sum(dim=1) / dt
    return diags


# --- the dense corrector -----------------------------------------------------

class DenseCorrector:
    """fv3fit's dense model from its dumped directory (``meta.json``,
    ``params.npy``, ``packer_out.json``, ``scaler_{in,out}.npz``):
    column inputs packed level by level, normalised in the state's
    dtype, a ReLU MLP in float32, denormalised in float32, unpacked into
    [6, nz, n, n] outputs."""

    def __init__(self, path: str, device):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with open(os.path.join(path, "packer_out.json")) as f:
            self.out_counts = json.load(f)["feature_counts"]
        self.inputs = meta["input_variables"]
        self.outputs = meta["output_variables"]
        sizes = [meta["n_in"]] + list(meta["widths"]) + [meta["n_out"]]
        flat = np.load(os.path.join(path, "params.npy"))
        # flax's Dense_0, Dense_1, ...: each bias, then its kernel
        # [in, out] row-major
        self.layers, i = [], 0
        for a, b in zip(sizes[:-1], sizes[1:]):
            bias = flat[i:i + b]
            i += b
            kernel = flat[i:i + a * b].reshape(a, b)
            i += a * b
            # stored as nn.Linear's [out, in] weight
            self.layers.append(tuple(
                torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                device=device)
                for x in (kernel.T, bias)))
        if i != flat.size:
            raise ValueError(f"params.npy holds {flat.size} numbers, the "
                             f"layers {sizes} take {i}")
        self.scalers = {}
        for which in ("in", "out"):
            with np.load(os.path.join(path, f"scaler_{which}.npz")) as d:
                self.scalers[which] = (np.asarray(d["mean"]),
                                       np.asarray(d["std"]))

    def _scaler(self, which, dtype, device):
        return tuple(torch.as_tensor(v, dtype=dtype, device=device)
                     for v in self.scalers[which])

    def __call__(self, fields):
        """{name: [6, nz, n, n]} inputs -> {name: [6, nz, n, n]}."""
        ref = fields[self.inputs[0]]
        x = torch.cat([torch.movedim(fields[k], 1, -1).reshape(
            -1, fields[k].shape[1]) for k in self.inputs], dim=1)
        mean_in, std_in = self._scaler("in", x.dtype, x.device)
        mean_out, std_out = self._scaler("out", torch.float32, x.device)
        h = ((x - mean_in) / std_in).float()
        for j, (weight, bias) in enumerate(self.layers):
            h = torch.nn.functional.linear(h, weight, bias)
            if j < len(self.layers) - 1:
                h = torch.relu(h)
        y = h * std_out + mean_out
        t, _, yy, xx = ref.shape
        out, i = {}, 0
        for name in self.outputs:
            w = self.out_counts[name]
            out[name] = torch.movedim(y[:, i:i + w].reshape(t, yy, xx, w),
                                      -1, 1)
            i += w
        return out


# --- the coupled step --------------------------------------------------------

class CoupledOutput(NamedTuple):
    state: hydro.DycoreState
    total_precip: torch.Tensor
    precip_rate: torch.Tensor
    diags: dict


class CoupledStep:
    """The coupled step of one configuration (``cfg``: the benchmark's
    configuration keys) in `dtype` on `device`, with the corrector
    dumped under `artifact`:

        step(state, tsfc, total_precip, time) -> CoupledOutput

    for a nonhydrostatic state at `time`, the step's start (phis = 0),
    whose q holds the six water species first; further tracers pass
    through physics and the corrector unchanged."""

    def __init__(self, cfg, artifact: str, dtype, device):
        self.cfg, self.dtype, self.device = cfg, dtype, device
        self.dt = cfg["dt_atmos"]
        self.ptop = cfg["ptop"]
        self.one_dt, _ = hydro.make_one_dt(
            cfg["resolution"], cfg["nz"], cfg["halo"], cfg["dt_atmos"],
            cfg["k_split"], cfg["n_split"], cfg["hord"], cfg["kord"],
            cfg["d2_damp"], cfg["ptop"], dtype=dtype, device=device)
        g = CubedSphereGrid.make(cfg["resolution"], halo=cfg["halo"])
        self.lon_deg = np.rad2deg(np.asarray(g.lon[g.interior]))
        self.lat_deg = np.rad2deg(np.asarray(g.lat[g.interior]))
        self.corrector = DenseCorrector(artifact, device)

    def solar(self, time: datetime.datetime):
        """(cosz, solcon) of the step that starts at `time`: at its end,
        as the program's loop takes them."""
        t_rad = time + datetime.timedelta(seconds=self.dt)
        cosz = np.maximum(
            cos_zenith_angle(t_rad, self.lon_deg, self.lat_deg), 0.0)
        opt = dict(dtype=self.dtype, device=self.device)
        return (torch.as_tensor(cosz, **opt),
                torch.full((), solar_constant(t_rad), **opt))

    def _temperature(self, st):
        return temperature_from_pt(st.delp, st.pt, st.q[0], self.ptop)

    def dynamics(self, state, phis):
        diags = {"water_vapor_path": (
            state.q[0] * state.delp / GRAV).sum(dim=1)}
        t_b = self._temperature(state)
        st = self.one_dt(state, phis)
        monitor(diags, "fv3_dynamics", t_b, state.q[0], state.delp,
                self._temperature(st), st.q[0], st.delp, self.dt)
        return st, diags

    def physics(self, st, tsfc, total_precip, cosz, solcon):
        dt, ptop, dtype = self.dt, self.ptop, self.dtype
        temp = self._temperature(st)
        qv, qc = st.q[0], st.q[1]
        out = gray_radiation(cosz, layer_pressure(st.delp, ptop), st.delp,
                             temp, qv, tsfc, solcon)
        temp = temp + (out["shortwave_heating_rate"]
                       + out["longwave_heating_rate"]) * dt
        diags = dict(out)
        t_b, q_b = temp, qv
        pout, pdiags = gfs_physics_step(
            temp, qv, qc, st.u, st.v, st.delp, tsfc, ptop, dt,
            mp_tracers=tuple(st.q[2:6]))
        temp = pout["air_temperature"]
        qv = pout["specific_humidity"]
        qc = pout["cloud_water_mixing_ratio"]
        extra = [pout[k] for k in MP_TRACER_NAMES]
        st = st._replace(u=pout["u_dgrid"].to(dtype),
                         v=pout["v_dgrid"].to(dtype))
        precip = pdiags.pop("total_precipitation")
        diags.update(pdiags)
        monitor(diags, "fv3_physics", t_b, q_b, st.delp, temp, qv, st.delp,
                dt)
        total_precip = total_precip + precip / 1000.0  # kg/m2 -> m
        precip_rate = precip / dt
        q_new = torch.stack([qv, qc] + extra).to(dtype)
        q_new = torch.cat([q_new, st.q[q_new.shape[0]:]], dim=0)
        st = st._replace(
            pt=pt_from_temperature(st.delp, temp, qv, ptop).to(dtype),
            q=q_new)
        return st, total_precip, precip_rate, diags

    def postphysics(self, st):
        dt, ptop, dtype = self.dt, self.ptop, self.dtype
        diags = {}
        temp = self._temperature(st)
        qv, qc = st.q[0], st.q[1]
        fields = {"air_temperature": temp, "specific_humidity": qv}
        preds = self.corrector(
            {k: fields[k] for k in self.corrector.inputs})
        tend = {}
        for k in ("dQ1", "dQ2"):
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
        delp2 = st.delp * (1.0 - qv) / (1.0 - qv2)
        monitor(diags, "python", temp, qv, st.delp, t2, qv2, delp2, dt)
        st = st._replace(
            delp=delp2.to(dtype),
            pt=pt_from_temperature(delp2, t2, qv2, ptop).to(dtype),
            q=torch.cat([torch.stack([qv2, qc]).to(dtype), st.q[2:]],
                        dim=0))
        return st, diags

    def __call__(self, state, tsfc, total_precip, time) -> CoupledOutput:
        """One coupled step from `state` (a ``hydro.DycoreState``) at
        `time`, with every tensor cast to the step's dtype first."""
        cast = lambda x: None if x is None else x.to(  # noqa: E731
            dtype=self.dtype, device=self.device)
        state = hydro.DycoreState(*(cast(x) for x in state))
        tsfc, total_precip = cast(tsfc), cast(total_precip)
        phis = torch.zeros_like(state.delp[:, 0])
        cosz, solcon = self.solar(time)
        with torch.no_grad():
            st, d1 = self.dynamics(state, phis)
            st, total_precip, precip_rate, d2 = self.physics(
                st, tsfc, total_precip, cosz, solcon)
            st, d3 = self.postphysics(st)
        return CoupledOutput(st, total_precip, precip_rate,
                             {**d1, **d2, **d3})
