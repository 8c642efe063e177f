"""The model wrapper of the coupled step (the JAX package's ``wrapper.py``:
the thermodynamic conversions, ``ModelConfig``, model initialisation and
the module-level ``initialize``/``get_model``).

``initialize`` builds the nonhydrostatic dycore stepper, the host
geometry, the initial state on an explicit device, and the physics
configuration that ``runtime.compiled_loop.build_compiled_step`` reads.
Not ported (they raise): the hydrostatic dycore, initialisation from
Fortran restarts, the GFDL microphysics tracers.  The stateful per-phase
API (``step_dynamics``, ``get_state``, ``set_state``, ...) waits for the
eager runtime (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import numpy as np
import torch

from .constants import KAPPA, REFERENCE_SURFACE_PRESSURE, ZVIR
from .dycore.hydro import (
    DycoreState,
    add_nonhydrostatic_fields,
    hybrid_coefficients,
    make_dycore_stepper,
)
from .grid.geometry import CubedSphereGrid
from .runtime import names


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
    microphysics_scheme: str = "zhao_carr"  # "gfdl" is not ported
    prognostic_mp_tracers: bool = False
    dtype: str = "float32"
    initial_time: str = "2016-08-01T00:00:00"
    restart_dir: Optional[str] = None


class _Model:
    """Module-level model instance (mirrors the Fortran global state)."""

    def initialize(self, config: Optional[ModelConfig] = None,
                   device=None):
        """Build the model on `device` (required: no CPU fallback)."""
        cfg = config or ModelConfig()
        if device is None:
            raise ValueError("initialize needs an explicit device")
        if cfg.prognostic_mp_tracers and not (
            cfg.physics_suite == "gfs"
            and cfg.microphysics_scheme == "gfdl"
        ):
            raise ValueError(
                "prognostic_mp_tracers requires physics_suite='gfs' "
                "with microphysics_scheme='gfdl'"
            )
        if cfg.hydrostatic:
            raise NotImplementedError(
                "the hydrostatic dycore is not ported: use "
                "hydrostatic=False"
            )
        if cfg.restart_dir is not None:
            raise NotImplementedError(
                "initialisation from Fortran restarts (io/restarts.py) is "
                "not ported"
            )
        if cfg.do_held_suarez:
            raise NotImplementedError(
                "held_suarez_tendencies is not ported"
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

    def _init_geometry(self):
        g = self.grid
        self.area = np.asarray(g.area[g.interior])
        self.lat = np.asarray(g.lat[g.interior])
        self.lon = np.asarray(g.lon[g.interior])

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
        self.tracer_names = (names.SPHUM, names.CLOUD)

        def t(a):
            return torch.as_tensor(
                np.ascontiguousarray(a), dtype=self.dtype, device=self.device
            )

        zeros = dict(dtype=self.dtype, device=self.device)
        self.state = add_nonhydrostatic_fields(
            DycoreState(
                t(delp), t(pt),
                torch.zeros((6, nz, n + 1, n), **zeros),
                torch.zeros((6, nz, n, n + 1), **zeros),
                torch.zeros((len(self.tracer_names), 6, nz, n, n), **zeros),
            ),
            self.config.ptop,
        )
        self.phis = torch.zeros((6, n, n), **zeros)
        self.tsfc = np.full((6, n, n), 288.0)
        self.total_precip = np.zeros((6, n, n))
        self.precip_rate = np.zeros((6, n, n))
        self.gfs_config = None
        self._radiation = None
        if self.config.physics_suite == "gfs":
            from .physics.gfs import GFSPhysicsConfig, check_config

            self.gfs_config = GFSPhysicsConfig(
                microphysics_scheme=self.config.microphysics_scheme
            )
            check_config(self.gfs_config)
            if self.config.do_radiation:
                from .physics.radiation import RadiationDriver

                self._radiation = RadiationDriver()


_model = _Model()

# module-level API matching fv3gfs.wrapper (the part that is ported)
initialize = _model.initialize


def get_model() -> _Model:
    return _model
