"""The model wrapper: the fv3gfs.wrapper API surface over the port's
core (the JAX package's ``wrapper.py``).

The reference's coupling runtime drives the model only through this
surface:

    initialize, cleanup, step_dynamics, step_pre_radiation,
    step_radiation, step_post_radiation_physics, apply_physics,
    save_intermediate_restart_if_enabled, get_step_count, get_state,
    set_state, set_state_mass_conserving, get_diagnostic_by_name,
    get_tracer_metadata, transform_agrid_winds_to_dgrid_winds,
    _properties

The model is the hydrostatic or nonhydrostatic dycore plus the simple
suite (saturation adjustment, Held-Suarez forcing) or the GFS suite with
gray radiation (Zhao-Carr or GFDL microphysics, the GFDL hydrometeors
optionally advected as dycore tracers).  It starts from the isothermal
rest state or from a directory of Fortran restart files
(``ModelConfig.restart_dir``).  The prognostic state lives in tensors on
the model's device (the CUDA device unless ``initialize`` is given
another), and every phase runs there; host numpy is read only where the
JAX package materialises too: the restart files (read and converted to
potential temperature in float64 on the host, io/restarts.py), the A-grid
wind transforms (float64, on the host) and the emulation hooks' state
dict.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from .constants import KAPPA, REFERENCE_SURFACE_PRESSURE, ZVIR
from .device import default_device
from .dycore.hydro import (
    DycoreState,
    add_nonhydrostatic_fields,
    hybrid_coefficients,
    make_dycore_stepper,
)
from .graphs import jit
from .grid.geometry import CubedSphereGrid
from .physics.gfs import gscond, precpd
from .physics.simple import held_suarez_tendencies, saturation_adjustment
from .util.quantity import Quantity, State

# canonical state names (data contract shared with the reference's
# runtime/names.py)
TEMP = "air_temperature"
SPHUM = "specific_humidity"
CLOUD = "cloud_water_mixing_ratio"
DELP = "pressure_thickness_of_atmospheric_layer"
X_WIND = "x_wind"
Y_WIND = "y_wind"
VERTICAL_WIND = "vertical_wind"
DELZ = "vertical_thickness_of_atmospheric_layer"
EASTWARD_WIND = "eastward_wind"
NORTHWARD_WIND = "northward_wind"
SFC_GEO = "surface_geopotential"
TSFC = "surface_temperature"
TOTAL_PRECIP = "total_precipitation"
PHYS_PRECIP_RATE = "surface_precipitation_rate"
AREA = "area_of_grid_cell"
LAT = "latitude"
LON = "longitude"
TIME = "time"

DIMS_3D = ("tile", "z", "y", "x")
DIMS_2D = ("tile", "y", "x")

# the JAX wrapper's jax.jit call sites (fv3net_tpu/wrapper.py:458, 484,
# 561, 581): on the card each is one replayed graph; the eager code
# around them (the conversions to and from potential temperature, the
# hooks' host dict) stays eager, as it does there.  precpd is captured
# once per key, where the JAX wrapper jits a new lambda at each call
# (ROADMAP quirk (u)).  gfs_physics_step is jitted where it is defined.
_held_suarez_tendencies = jit(held_suarez_tendencies)
_saturation_adjustment = jit(saturation_adjustment)
_gscond = jit(gscond)
_precpd = jit(precpd)

CLOUD_ICE = "cloud_ice_mixing_ratio"
RAIN = "rain_mixing_ratio"
SNOW = "snow_mixing_ratio"
GRAUPEL = "graupel_mixing_ratio"

# tracer registry in dycore-q order; the 6-species set mirrors the
# reference's in-dycore GFDL MP tracer list
TRACER_NAMES_2 = (SPHUM, CLOUD)
TRACER_NAMES_6 = (SPHUM, CLOUD, CLOUD_ICE, RAIN, SNOW, GRAUPEL)
_FORTRAN_TRACER = {
    SPHUM: "sphum",
    CLOUD: "liq_wat",
    CLOUD_ICE: "ice_wat",
    RAIN: "rainwat",
    SNOW: "snowwat",
    GRAUPEL: "graupel",
}
TRACER_METADATA = {
    SPHUM: {"i_tracer": 1, "fortran_name": "sphum", "units": "kg/kg"},
    CLOUD: {"i_tracer": 2, "fortran_name": "liq_wat", "units": "kg/kg"},
}

DYNAMICS_PROPERTIES = [
    {"name": n, "dims": DIMS_3D, "units": u}
    for n, u in [
        (TEMP, "degK"),
        (DELP, "Pa"),
        (X_WIND, "m/s"),
        (Y_WIND, "m/s"),
    ]
] + [{"name": SFC_GEO, "dims": DIMS_2D, "units": "m**2/s**2"}]
PHYSICS_PROPERTIES = [
    {"name": TSFC, "dims": DIMS_2D, "units": "degK"},
    {"name": TOTAL_PRECIP, "dims": DIMS_2D, "units": "m"},
]


@dataclasses.dataclass
class _Properties:
    DYNAMICS_PROPERTIES = DYNAMICS_PROPERTIES
    PHYSICS_PROPERTIES = PHYSICS_PROPERTIES


_properties = _Properties()


# --- pure thermodynamic conversions (shared with the compiled loop) --------


def pressure_layers(delp, ptop):
    """(pe, pi_lay): interface pressures and hydrostatically consistent
    layer-mean Exner function from layer thicknesses."""
    pe = ptop + torch.cat(
        [torch.zeros_like(delp[:, :1]), torch.cumsum(delp, dim=1)], dim=1
    )
    pik = (pe / REFERENCE_SURFACE_PRESSURE) ** KAPPA
    pi_lay = (
        pik[:, 1:] * pe[:, 1:] - pik[:, :-1] * pe[:, :-1]
    ) / ((1.0 + KAPPA) * delp)
    return pe, pi_lay


def temperature_from_pt(delp, pt, qv, ptop):
    """Sensible temperature from virtual potential temperature."""
    _, pi = pressure_layers(delp, ptop)
    return pt * pi / (1.0 + ZVIR * qv)


def pt_from_temperature(delp, temp, qv, ptop):
    """Virtual potential temperature from sensible temperature."""
    _, pi = pressure_layers(delp, ptop)
    return temp * (1.0 + ZVIR * qv) / pi


def _host64(x) -> np.ndarray:
    """A tensor (on any device) or an array as a float64 host array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _host(x) -> np.ndarray:
    """A tensor (on any device) or an array as a host array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class ModelConfig:
    npx: int = 13  # cells per face edge + 1 (FV3 namelist convention)
    npz: int = 63
    dt_atmos: float = 900.0
    k_split: int = 1
    n_split: int = 6
    hord: int = 5
    kord: int = 9
    ptop: float = 300.0
    hydrostatic: bool = True
    do_held_suarez: bool = False
    do_sat_adj: bool = True
    physics_suite: str = "simple"  # "simple" | "gfs" | "none"
    do_radiation: bool = True  # gray radiation inside the gfs suite
    # "zhao_carr" | "gfdl" (GFSPhysicsConfig.microphysics_scheme)
    microphysics_scheme: str = "zhao_carr"
    # "betts_miller" | "mass_flux" (GFSPhysicsConfig.convection_scheme;
    # the JAX package's ModelConfig has no such field and always runs
    # Betts-Miller)
    convection_scheme: str = "betts_miller"
    # carry ice/rain/snow/graupel as advected dycore tracers (the
    # reference's in-dycore GFDL MP over the full tracer set)
    prognostic_mp_tracers: bool = False
    dtype: str = "float32"
    initial_time: str = "2016-08-01T00:00:00"
    # FV3GFS run directory with INPUT/*.tile?.nc Fortran restarts; the
    # prognostic state (and the time, from coupler.res) starts from it
    restart_dir: Optional[str] = None


class _Model:
    """Module-level model instance (mirrors the Fortran global state)."""

    def __init__(self):
        self.initialized = False

    def initialize(self, config: Optional[ModelConfig] = None,
                   device=None):
        """Build the model on `device`: the CUDA device unless the caller
        names another (``device="cpu"`` for the plain path); without a
        CUDA device the default raises."""
        cfg = config or ModelConfig()
        if device is None:
            device = default_device("initialize")
        if cfg.prognostic_mp_tracers and not (
            cfg.physics_suite == "gfs"
            and cfg.microphysics_scheme == "gfdl"
        ):
            raise ValueError(
                "prognostic_mp_tracers requires physics_suite='gfs' "
                "with microphysics_scheme='gfdl'"
            )
        self.config = cfg
        self.device = torch.device(device)
        n = cfg.npx - 1
        self.n = n
        self.nz = cfg.npz
        self.dtype = torch.float32 if cfg.dtype == "float32" else torch.float64
        self.grid = CubedSphereGrid.make(n, halo=3)
        self.run_step, self.metrics, (self.ak, self.bk) = make_dycore_stepper(
            self.grid, cfg.npz, cfg.dt_atmos, k_split=cfg.k_split,
            n_split=cfg.n_split, hord=cfg.hord, kord=cfg.kord, ptop=cfg.ptop,
            dtype=self.dtype, device=self.device,
        )
        self._init_geometry()
        self._init_state()
        self.step_count = 0
        self.time = datetime.datetime.fromisoformat(cfg.initial_time)
        if cfg.restart_dir is not None:
            self._init_from_restart(cfg.restart_dir)
        self.initialized = True

    def _init_from_restart(self, rundir: str):
        """Ingest a Fortran restart directory (INPUT/ preferred, else the
        newest RESTART prefix) into the prognostic state on the model's
        device.  The files are read, and T converted to pt, on the host
        (io/restarts.py, float64, every field then rounded to float32 as
        the JAX package rounds it)."""
        import os

        from .io.restarts import (
            open_restarts,
            read_coupler_res,
            state_from_restarts,
        )

        opened = open_restarts(rundir)
        if not opened:
            raise FileNotFoundError(f"no restart files under {rundir}")
        prefix = "INPUT" if "INPUT" in opened else sorted(opened)[-1]
        st, phis = state_from_restarts(opened[prefix], self.config.ptop)
        expect = (6, self.nz, self.n, self.n)
        if st.delp.shape != expect:
            raise ValueError(
                f"restart resolution {st.delp.shape} does not match the "
                f"configured model {expect}"
            )
        st = DycoreState(*[None if x is None else self._tensor(x)
                           for x in st])
        if not self.config.hydrostatic and st.w is None:
            st = add_nonhydrostatic_fields(st, self.config.ptop)
        nt = len(self.tracer_names)
        zeros = dict(dtype=self.dtype, device=self.device)
        if st.q is None:
            st = st._replace(
                q=torch.zeros((nt, 6, self.nz, self.n, self.n), **zeros)
            )
        elif st.q.shape[0] < nt:
            # a restart with fewer species than the configured tracer
            # set: the missing hydrometeors start at zero
            pad = torch.zeros((nt - st.q.shape[0],) + st.q.shape[1:],
                              **zeros)
            st = st._replace(q=torch.cat([st.q, pad], dim=0))
        self.state = st
        self.phis = self._tensor(phis)
        coupler = os.path.join(rundir, prefix, "coupler.res")
        if os.path.exists(coupler):
            self.time = read_coupler_res(coupler)

    def _tensor(self, x):
        """x (an array or a tensor on any device) in the model's dtype on
        its device."""
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def _init_geometry(self):
        g = self.grid
        self.area = np.asarray(g.area[g.interior])
        self.lat = np.asarray(g.lat[g.interior])
        self.lon = np.asarray(g.lon[g.interior])
        self._lat_t = self._tensor(self.lat)
        # local east/north and x/y unit vectors at cell centers (interior)
        ee = g.e_east[g.interior + (np.s_[:],)]
        en = g.e_north[g.interior + (np.s_[:],)]
        c = g.centers_xyz
        h, n = g.halo, g.n
        tx = c[:, h : h + n, h + 1 : h + n + 1] - c[
            :, h : h + n, h - 1 : h + n - 1
        ]
        ty = c[:, h + 1 : h + n + 1, h : h + n] - c[
            :, h - 1 : h + n - 1, h : h + n
        ]
        cc = c[:, h : h + n, h : h + n]
        tx = tx - np.sum(tx * cc, axis=-1, keepdims=True) * cc
        ty = ty - np.sum(ty * cc, axis=-1, keepdims=True) * cc
        tx /= np.linalg.norm(tx, axis=-1, keepdims=True)
        ty /= np.linalg.norm(ty, axis=-1, keepdims=True)
        # rotation between (x,y) local components and (east,north)
        self.x_dot_e = np.sum(tx * ee, axis=-1)
        self.x_dot_n = np.sum(tx * en, axis=-1)
        self.y_dot_e = np.sum(ty * ee, axis=-1)
        self.y_dot_n = np.sum(ty * en, axis=-1)
        # D-grid edge tangents for A->D transforms
        cor = g.corners_xyz[:, h : h + n + 1, h : h + n + 1]

        def tang(a, b):
            mid = a + b
            mid /= np.linalg.norm(mid, axis=-1, keepdims=True)
            t = b - a
            t = t - np.sum(t * mid, axis=-1, keepdims=True) * mid
            return t / np.linalg.norm(t, axis=-1, keepdims=True), mid

        self.tu, self.mu = tang(cor[:, :, :-1], cor[:, :, 1:])
        self.tv, self.mv = tang(cor[:, :-1, :], cor[:, 1:, :])
        zhat = np.array([0.0, 0.0, 1.0])

        def en_basis(mid):
            e = np.cross(np.broadcast_to(zhat, mid.shape), mid)
            e /= np.maximum(
                np.linalg.norm(e, axis=-1, keepdims=True), 1e-300
            )
            nn = np.cross(mid, e)
            return e, nn

        self.eu, self.nu_ = en_basis(self.mu)
        self.ev, self.nv_ = en_basis(self.mv)

    def _init_state(self):
        n, nz = self.n, self.nz
        # the float64 coordinate, as the JAX package builds its state
        ak, bk = (c.numpy() for c in hybrid_coefficients(nz, self.config.ptop))
        ps = 1.0e5
        pe = ak[:, None, None] + bk[:, None, None] * ps
        delp = np.broadcast_to(pe[1:] - pe[:-1], (6, nz, n, n))
        # isothermal 280 K in theta_v
        pik = (pe / REFERENCE_SURFACE_PRESSURE) ** KAPPA
        pi_lay = 0.5 * (pik[1:] + pik[:-1])
        pt = np.broadcast_to(280.0 / pi_lay, (6, nz, n, n))
        self.tracer_names = (
            TRACER_NAMES_6
            if self.config.prognostic_mp_tracers
            else TRACER_NAMES_2
        )
        self._tracer_index = {
            nm: i for i, nm in enumerate(self.tracer_names)
        }
        zeros = dict(dtype=self.dtype, device=self.device)
        self.state = DycoreState(
            self._tensor(np.ascontiguousarray(delp)),
            self._tensor(np.ascontiguousarray(pt)),
            torch.zeros((6, nz, n + 1, n), **zeros),
            torch.zeros((6, nz, n, n + 1), **zeros),
            torch.zeros((len(self.tracer_names), 6, nz, n, n), **zeros),
        )
        if not self.config.hydrostatic:
            # the reference namelist's `hydrostatic: false`: prognostic w
            # and delz
            self.state = add_nonhydrostatic_fields(
                self.state, self.config.ptop
            )
        self.phis = torch.zeros((6, n, n), **zeros)
        self.tsfc = np.full((6, n, n), 288.0)
        # accumulated precipitation (m) in float64 on the device, as the
        # JAX package accumulates it (float64 host zeros plus device
        # precipitation)
        self.total_precip = torch.zeros(
            (6, n, n), dtype=torch.float64, device=self.device
        )
        self.precip_rate = torch.zeros(
            (6, n, n), dtype=torch.float64, device=self.device
        )
        self._intermediate_restarts: List[str] = []
        # GFS-suite extras
        self.emulation_hooks = None  # (gscond, microphysics, store)
        self.gfs_config = None
        self._radiation = None
        self._physics_diags: Dict[str, torch.Tensor] = {}
        if self.config.physics_suite == "gfs":
            from .physics.gfs import GFSPhysicsConfig

            self.gfs_config = GFSPhysicsConfig(
                microphysics_scheme=self.config.microphysics_scheme,
                convection_scheme=self.config.convection_scheme,
            )
            if self.config.do_radiation:
                from .physics.radiation import RadiationDriver

                self._radiation = RadiationDriver()

    # --- thermodynamic conversions ---------------------------------------

    def _pressure_layers(self, delp):
        return pressure_layers(delp, self.config.ptop)

    def _temperature(self):
        return temperature_from_pt(
            self.state.delp, self.state.pt, self.state.q[0],
            self.config.ptop,
        )

    def _set_temperature(self, temp):
        pt = pt_from_temperature(
            self.state.delp, self._tensor(temp), self.state.q[0],
            self.config.ptop,
        )
        self.state = self.state._replace(pt=pt.to(self.dtype))

    def _tsfc_tensor(self):
        return self._tensor(self.tsfc)

    # --- steps ------------------------------------------------------------

    def step_dynamics(self):
        # on the card a replay of the stepper's captured dt; not donated
        # (the stepper's default), as the JAX wrapper's: callers may hold
        # the state from before the step
        self.state = self.run_step(self.state, self.phis, 1)
        self.step_count += 1
        self.time += datetime.timedelta(seconds=self.config.dt_atmos)

    def step_pre_radiation(self):
        pass  # surface/boundary-layer setup slot (no-op in simple suite)

    def step_radiation(self):
        """Gray-radiation heating inside the gfs suite (the reference
        steps the Fortran RRTMG here)."""
        if self._radiation is None:
            return
        delp = self.state.delp
        temp = self._temperature()
        sphum = self.state.q[0]
        pe, _ = self._pressure_layers(delp)
        p_lay = 0.5 * (pe[:, 1:] + pe[:, :-1])
        self._radiation.radupdate(self.time)
        out = self._radiation.gfs_radiation_driver(
            self.time,
            np.rad2deg(self.lon),
            np.rad2deg(self.lat),
            p_lay,
            delp,
            temp,
            sphum,
            self._tsfc_tensor(),
        )
        heating = (
            out["shortwave_heating_rate"] + out["longwave_heating_rate"]
        )
        self._set_temperature(temp + heating * self.config.dt_atmos)
        # diagnostics stay on the device; a sink copies them to the host
        # when it reads .values
        self._physics_diags.update(dict(out))

    def step_post_radiation_physics(self):
        if self.config.do_held_suarez:
            delp = self.state.delp
            temp = self._temperature()
            u, v = self.state.u, self.state.v
            pe, _ = self._pressure_layers(delp)
            dT, du, dv = _held_suarez_tendencies(
                temp, u, v, pe, self._lat_t, self.config.dt_atmos,
            )
            self._set_temperature(temp + dT)
            self.state = self.state._replace(
                u=(u + du).to(self.dtype),
                v=(v + dv).to(self.dtype),
            )

    def apply_physics(self):
        if self.config.physics_suite == "gfs":
            self._apply_gfs_physics()
            return
        if self.config.physics_suite == "none":
            return
        if self.config.do_sat_adj:
            delp = self.state.delp
            temp = self._temperature()
            q = self.state.q
            pe, _ = self._pressure_layers(delp)
            p_lay = 0.5 * (pe[:, 1:] + pe[:, :-1])
            temp2, qv2, qc2, precip = _saturation_adjustment(
                temp, q[0], q[1], p_lay, delp, self.config.dt_atmos
            )
            # the JAX package converts with the humidity before the
            # adjustment, then sets it
            self._set_temperature(temp2)
            self.state = self.state._replace(
                q=torch.stack([qv2, qc2]).to(self.dtype)
            )
            self.total_precip = (
                self.total_precip + precip / 1000.0
            )  # kg/m2 -> m
            self.precip_rate = precip / self.config.dt_atmos

    def _apply_gfs_physics(self):
        """Run the GFS-style suite (PBL + convection + Zhao-Carr or GFDL
        microphysics), with online-emulation hook points around the
        microphysics like the reference's call_py_fort flow: the physics
        result is pushed into a host state dict under the Zhao-Carr
        names, hooks may write ``*_output`` keys that substitute it, and
        the store hook captures everything for training data."""
        from .physics.gfs import MP_TRACER_NAMES, gfs_physics_step

        cfg = self.gfs_config
        dt = self.config.dt_atmos
        dtype = self.dtype
        t = self._temperature()
        qv = self.state.q[0]
        qc = self.state.q[1]
        delp = self.state.delp
        tsfc = self._tsfc_tensor()
        hooks = self.emulation_hooks
        inline_micro = hooks is None

        run_cfg = dataclasses.replace(cfg, do_microphysics=inline_micro)
        # the prognostic hydrometeors flow only through the inline GFDL
        # scheme; with emulation hooks the microphysics is bypassed and
        # they pass through unchanged (below)
        mp_tracers = (
            tuple(self.state.q[2:6])
            if inline_micro
            and len(self.tracer_names) >= 6
            and cfg.microphysics_scheme == "gfdl"
            else None
        )
        out, diags = gfs_physics_step(
            t, qv, qc, self.state.u, self.state.v, delp, tsfc,
            self.config.ptop, dt, cfg=run_cfg, mp_tracers=mp_tracers,
        )
        t2 = out["air_temperature"]
        qv2 = out["specific_humidity"]
        qc2 = out["cloud_water_mixing_ratio"]
        precip = diags["total_precipitation"].to(torch.float64)

        if not inline_micro:
            gscond_hook, micro_hook, store_hook = hooks
            pe, _ = self._pressure_layers(delp.to(torch.float64))
            p = (0.5 * (pe[:, 1:] + pe[:, :-1])).to(dtype)
            sd = {
                "air_temperature_input": _host(t2),
                "specific_humidity_input": _host(qv2),
                "cloud_water_mixing_ratio_input": _host(qc2),
                "pressure_thickness_of_atmospheric_layer": _host(delp),
                "air_pressure": _host(p),
                "surface_air_pressure": _host(pe[:, -1]),
                "latitude": self.lat,
                "longitude": self.lon,
                "time": self.time,
            }
            # gscond: compute physics, let the hook substitute
            tg, qvg, qcg = _gscond(t2, qv2, qc2, p, dt)
            sd["air_temperature_after_gscond"] = _host(tg)
            sd["specific_humidity_after_gscond"] = _host(qvg)
            sd["cloud_water_mixing_ratio_after_gscond"] = _host(qcg)
            gscond_hook(sd)
            tg, qvg, qcg = (
                self._tensor(sd.pop(f"{k}_output", sd[f"{k}_after_gscond"]))
                for k in (TEMP, SPHUM, CLOUD)
            )
            # precpd
            tp, qvp, qcp, pr = _precpd(tg, qvg, qcg, p, delp, dt, cfg)
            sd["air_temperature_after_precpd"] = _host(tp)
            sd["specific_humidity_after_precpd"] = _host(qvp)
            sd["cloud_water_mixing_ratio_after_precpd"] = _host(qcp)
            sd["total_precipitation"] = _host(pr)
            micro_hook(sd)
            t2, qv2, qc2 = (
                self._tensor(sd.get(f"{k}_output", sd[f"{k}_after_precpd"]))
                for k in (TEMP, SPHUM, CLOUD)
            )
            pr = sd.get("total_precipitation_output",
                        sd["total_precipitation"])
            precip = precip + torch.as_tensor(
                _host64(pr), device=self.device
            )
            store_hook(sd)

        extra = ([out[k] for k in MP_TRACER_NAMES]
                 if mp_tracers is not None else [])
        # species beyond the suite's prognostic set pass through unchanged
        q_new = torch.stack([qv2, qc2] + extra)
        q_new = torch.cat([q_new, self.state.q[q_new.shape[0]:]], dim=0)
        self.state = self.state._replace(
            q=q_new.to(dtype),
            u=out["u_dgrid"].to(dtype),
            v=out["v_dgrid"].to(dtype),
        )
        self._set_temperature(t2)
        self.total_precip = self.total_precip + precip / 1000.0  # kg/m2 -> m
        self.precip_rate = precip / dt
        self._physics_diags.update(
            {
                k: v
                for k, v in diags.items()
                if k != "total_precipitation"
            }
        )

    def save_intermediate_restart_if_enabled(self):
        pass  # wired by the segmented-run layer

    # --- state access -----------------------------------------------------

    def get_state(self, names) -> State:
        out: State = {}
        for name in names:
            if name == TIME:
                out[name] = self.time  # type: ignore
            elif name == TEMP:
                out[name] = Quantity(self._temperature(), DIMS_3D, "degK")
            elif name == DELP:
                out[name] = Quantity(self.state.delp, DIMS_3D, "Pa")
            elif name in self._tracer_index:
                out[name] = Quantity(
                    self.state.q[self._tracer_index[name]],
                    DIMS_3D, "kg/kg",
                )
            elif name == X_WIND:
                out[name] = Quantity(
                    self.state.u,
                    ("tile", "z", "y_interface", "x"), "m/s",
                )
            elif name == Y_WIND:
                out[name] = Quantity(
                    self.state.v,
                    ("tile", "z", "y", "x_interface"), "m/s",
                )
            elif name == VERTICAL_WIND:
                if self.state.w is None:
                    raise KeyError(
                        "vertical_wind requires hydrostatic=False"
                    )
                out[name] = Quantity(self.state.w, DIMS_3D, "m/s")
            elif name == DELZ:
                if self.state.delz is None:
                    raise KeyError(f"{DELZ} requires hydrostatic=False")
                out[name] = Quantity(self.state.delz, DIMS_3D, "m")
            elif name in (EASTWARD_WIND, NORTHWARD_WIND):
                ua, va = self._agrid_winds()
                out[EASTWARD_WIND] = Quantity(ua, DIMS_3D, "m/s")
                out[NORTHWARD_WIND] = Quantity(va, DIMS_3D, "m/s")
            elif name == SFC_GEO:
                # a host copy, as the JAX package hands it out
                out[name] = Quantity(_host(self.phis), DIMS_2D, "m**2/s**2")
            elif name == TSFC:
                out[name] = Quantity(self.tsfc.copy(), DIMS_2D, "degK")
            elif name == TOTAL_PRECIP:
                out[name] = Quantity(self.total_precip.clone(), DIMS_2D, "m")
            elif name == PHYS_PRECIP_RATE:
                out[name] = Quantity(
                    self.precip_rate.clone(), DIMS_2D, "kg/m**2/s"
                )
            elif name == AREA:
                out[name] = Quantity(self.area.copy(), DIMS_2D, "m**2")
            elif name == LAT:
                out[name] = Quantity(self.lat.copy(), DIMS_2D, "radians")
            elif name == LON:
                out[name] = Quantity(self.lon.copy(), DIMS_2D, "radians")
            else:
                raise KeyError(f"unknown state name: {name}")
        return out

    def set_state(self, state: Mapping[str, Quantity]):
        # TEMP is stored as virtual potential temperature: its
        # conversion reads delp and sphum, so set those first --
        # otherwise the result depends on dict insertion order
        items = sorted(state.items(), key=lambda kv: kv[0] == TEMP)
        for name, qty in items:
            if name == TIME:
                self.time = qty  # type: ignore
            elif name == TEMP:
                self._set_temperature(qty.data)
            elif name == DELP:
                self.state = self.state._replace(
                    delp=self._tensor(qty.data)
                )
            elif name in self._tracer_index:
                q = self.state.q.clone()
                q[self._tracer_index[name]] = self._tensor(qty.data)
                self.state = self.state._replace(q=q)
            elif name == X_WIND:
                self.state = self.state._replace(u=self._tensor(qty.data))
            elif name == Y_WIND:
                self.state = self.state._replace(v=self._tensor(qty.data))
            elif name == VERTICAL_WIND:
                self.state = self.state._replace(w=self._tensor(qty.data))
            elif name == DELZ:
                self.state = self.state._replace(
                    delz=self._tensor(qty.data)
                )
            elif name == TSFC:
                self.tsfc = _host(qty.data).copy()
            elif name == TOTAL_PRECIP:
                self.total_precip = torch.as_tensor(
                    qty.data, dtype=torch.float64, device=self.device
                ).clone()
            elif name == SFC_GEO:
                self.phis = self._tensor(qty.data)
            else:
                raise KeyError(f"cannot set state name: {name}")

    def set_state_mass_conserving(self, state: Mapping[str, Quantity]):
        """Humidity updates adjust delp to conserve dry air mass, in
        float64 as the JAX package computes it, on the model's device."""
        state = dict(state)
        if SPHUM in state:
            f64 = dict(dtype=torch.float64, device=self.device)
            q_old = self.state.q[0].to(torch.float64)
            q_new = torch.as_tensor(state[SPHUM].data, **f64)
            delp = self.state.delp.to(torch.float64)
            delp_new = delp * (1.0 - q_old) / (1.0 - q_new)
            self.state = self.state._replace(delp=delp_new.to(self.dtype))
        self.set_state(state)

    # --- winds (host float64, as the JAX package computes them) -----------

    def _agrid_winds(self):
        u = _host64(self.state.u)
        v = _host64(self.state.v)
        ux = 0.5 * (u[:, :, :-1, :] + u[:, :, 1:, :])
        vy = 0.5 * (v[:, :, :, :-1] + v[:, :, :, 1:])
        ua = ux * self.x_dot_e[:, None] + vy * self.y_dot_e[:, None]
        va = ux * self.x_dot_n[:, None] + vy * self.y_dot_n[:, None]
        return ua, va

    def transform_agrid_winds_to_dgrid_winds(
        self, u_quantity: Quantity, v_quantity: Quantity
    ):
        """(eastward, northward) A-grid vectors -> D-grid edge components
        (the wrapper call used to apply A-grid wind tendencies)."""
        ua = _host64(u_quantity.data)
        va = _host64(v_quantity.data)
        # interpolate to edges then project onto edge tangents
        ua_u = np.concatenate(
            [ua[:, :, :1], 0.5 * (ua[:, :, 1:] + ua[:, :, :-1]),
             ua[:, :, -1:]], axis=2,
        )
        va_u = np.concatenate(
            [va[:, :, :1], 0.5 * (va[:, :, 1:] + va[:, :, :-1]),
             va[:, :, -1:]], axis=2,
        )
        ua_v = np.concatenate(
            [ua[:, :, :, :1], 0.5 * (ua[:, :, :, 1:] + ua[:, :, :, :-1]),
             ua[:, :, :, -1:]], axis=3,
        )
        va_v = np.concatenate(
            [va[:, :, :, :1], 0.5 * (va[:, :, :, 1:] + va[:, :, :, :-1]),
             va[:, :, :, -1:]], axis=3,
        )
        tu_e = np.sum(self.tu * self.eu, axis=-1)[:, None]
        tu_n = np.sum(self.tu * self.nu_, axis=-1)[:, None]
        tv_e = np.sum(self.tv * self.ev, axis=-1)[:, None]
        tv_n = np.sum(self.tv * self.nv_, axis=-1)[:, None]
        du = ua_u * tu_e + va_u * tu_n
        dv = ua_v * tv_e + va_v * tv_n
        return (
            Quantity(du, ("tile", "z", "y_interface", "x"), "m/s"),
            Quantity(dv, ("tile", "z", "y", "x_interface"), "m/s"),
        )

    def get_diagnostic_by_name(self, name: str) -> Quantity:
        if name in self._physics_diags:
            arr = self._physics_diags[name]
            dims = DIMS_3D if arr.ndim == 4 else DIMS_2D
            units = "W/m**2" if "flux" in name else (
                "K/s" if "heating" in name else "")
            return Quantity(arr.clone(), dims, units)
        mapping = {
            "total_precipitation_rate": PHYS_PRECIP_RATE,
            PHYS_PRECIP_RATE: PHYS_PRECIP_RATE,
        }
        return self.get_state([mapping.get(name, name)])[
            mapping.get(name, name)
        ]

    def get_tracer_metadata(self) -> Dict:
        return {
            nm: {
                "i_tracer": i + 1,
                "fortran_name": _FORTRAN_TRACER[nm],
                "units": "kg/kg",
            }
            for i, nm in enumerate(self.tracer_names)
        }

    def get_step_count(self) -> int:
        return self.step_count

    def cleanup(self):
        self.initialized = False


_model = _Model()

# module-level API matching fv3gfs.wrapper
initialize = _model.initialize
cleanup = _model.cleanup
step_dynamics = _model.step_dynamics
step_pre_radiation = _model.step_pre_radiation
step_radiation = _model.step_radiation
step_post_radiation_physics = _model.step_post_radiation_physics
apply_physics = _model.apply_physics
save_intermediate_restart_if_enabled = (
    _model.save_intermediate_restart_if_enabled
)
get_step_count = _model.get_step_count
get_state = _model.get_state
set_state = _model.set_state
set_state_mass_conserving = _model.set_state_mass_conserving
get_diagnostic_by_name = _model.get_diagnostic_by_name
get_tracer_metadata = _model.get_tracer_metadata
transform_agrid_winds_to_dgrid_winds = (
    _model.transform_agrid_winds_to_dgrid_winds
)


def get_model() -> _Model:
    return _model
