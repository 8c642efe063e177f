"""The nudged run (fv3net's training-data path) set up for the port.

fv3net makes its training data with a nudged run: a model initialised
from Fortran restarts, relaxed toward time-interpolated reference
snapshots, whose ``{var}_tendency_due_to_nudging`` become the dQ1/dQ2
targets (``data.open_nudge_to_fine``).  This module writes such a case
from a seed and builds the model and the nudger for it:

* ``write_input``: ``<rundir>/INPUT/`` (``io.restarts.write_restarts``)
  and ``coupler.res`` at T0, from a moist, perturbed state on the hybrid
  coordinate: temperature with 1 K of seeded noise, smooth winds of
  5 m/s, humidity at a seeded relative humidity per column up to 1.1
  (falling off aloft as (p / ps)^3), cloud liquid, ice, rain, snow and
  graupel, vertical wind 0 and hydrostatic layer thicknesses;
* ``write_snapshots``: two reference snapshots at T0 and T0 + 1 h (or
  another window; the
  initial temperature + 3 K and humidity + 1e-4, as the JAX package's
  tests/test_nudging_e2e.py), in the ``<YYYYMMDD.HHMMSS>/`` layout that
  ``runtime.nudging`` reads;
* ``initialize``: both where absent, the wrapper initialised from INPUT/
  with the slice's configuration (``SLICE``: C<n> x 63 nonhydrostatic,
  GFS suite with gray radiation and GFDL microphysics over six advected
  species, dt_atmos 900 s, n_split 6, hord 5, kord 9), and the nudger of
  T and specific humidity (3 h).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

from ..constants import GRAV, RDGAS, ZVIR
from ..util.quantity import Quantity
from . import names

SLICE = dict(
    npz=63, dt_atmos=900.0, k_split=1, n_split=6, hord=5, kord=9,
    hydrostatic=False, physics_suite="gfs", do_radiation=True,
    microphysics_scheme="gfdl", prognostic_mp_tracers=True,
)
TIMESCALE_HOURS = {names.TEMP: 3.0, names.SPHUM: 3.0}
T0 = datetime.datetime(2016, 8, 1, 0, 0, 0)
PTOP = 300.0
DIMS = ("tile", "z", "y", "x")


def restart_fields(n: int, seed: int = 0):
    """The restart fields (name -> Quantity, float64) of the seeded moist
    state at C<n> x 63 (module docstring)."""
    from ..dycore.hydro import DycoreState, hybrid_coefficients
    from ..io.restarts import restarts_from_state
    from ..parity import smooth_wind
    from ..physics.gfs import qsat

    nz = SLICE["npz"]
    rng = np.random.RandomState(seed)
    ak, bk = (c.numpy() for c in hybrid_coefficients(nz, PTOP))
    pe = ak[:, None, None] + bk[:, None, None] * 1.0e5
    pe = np.broadcast_to(pe, (6, nz + 1, n, n))
    delp = pe[:, 1:] - pe[:, :-1]
    p = 0.5 * (pe[:, 1:] + pe[:, :-1])
    temp = np.maximum(300.0 * (p / 1.0e5) ** 0.19, 210.0)
    temp = temp + rng.randn(6, nz, n, n)
    qs = qsat(torch.as_tensor(temp), torch.as_tensor(p)).numpy()
    rh = rng.uniform(0.5, 1.1, size=(6, 1, n, n))
    q = np.stack([
        rh * (p / p[:, -1:]) ** 3 * qs,
        1e-4 * rng.rand(6, nz, n, n) * (temp > 250.0),
        1e-4 * rng.rand(6, nz, n, n) * (temp < 260.0),
        1e-4 * rng.rand(6, nz, n, n) * (p > 4.0e4),
        5e-5 * rng.rand(6, nz, n, n) * (temp < 270.0),
        2e-5 * rng.rand(6, nz, n, n) * (temp < 270.0),
    ])
    delz = -(RDGAS / GRAV) * temp * (1.0 + ZVIR * q[0]) * np.log(
        pe[:, 1:] / pe[:, :-1])
    state = DycoreState(
        delp=delp, pt=temp,
        u=smooth_wind((6, nz, n + 1, n), 0.0),
        v=smooth_wind((6, nz, n, n + 1), 1.0),
        q=q, w=np.zeros_like(delp), delz=delz,
    )
    fields = restarts_from_state(state, np.zeros((6, n, n)), PTOP)
    fields["T"] = fields["T"].with_data(temp)  # the temperature itself
    return fields


def write_input(rundir: str, n: int, seed: int = 0) -> str:
    """<rundir>/INPUT/ (restart files and coupler.res at T0) of the
    seeded moist state; returns rundir."""
    from ..io.restarts import write_restarts

    write_restarts(restart_fields(n, seed), rundir, time=T0, subdir="INPUT")
    return rundir


def write_snapshots(path: str, temperature, sphum, t0=T0,
                    window_hours: float = 1.0) -> str:
    """Reference snapshots at t0 and t0 + window_hours under `path`:
    temperature + 3 K and specific humidity + 1e-4 (host arrays
    [6, nz, n, n])."""
    from ..io.restarts import write_restarts
    from .nudging import time_to_label

    for hours in (0.0, window_hours):
        label = time_to_label(t0 + datetime.timedelta(hours=hours))
        write_restarts(
            {"T": Quantity(np.asarray(temperature) + 3.0, DIMS, "K"),
             "sphum": Quantity(np.asarray(sphum) + 1e-4, DIMS, "kg/kg")},
            path, subdir=label)
    return path


def model_config(n: int, rundir: str, dtype: str = "float32"):
    """The slice's ModelConfig at C<n>, initialised from rundir."""
    from .. import wrapper

    return wrapper.ModelConfig(npx=n + 1, dtype=dtype, restart_dir=rundir,
                               **SLICE)


def initialize(n: int, device, root: str, dtype: str = "float32",
               seed: int = 0, window_hours: float = 1.0):
    """Initialise the wrapper on `device` from the case under `root`
    (run/INPUT and reference/) and build the nudger.  The parts of the
    case that are absent are written first, the snapshots from this
    model's initial state; so a case written once serves several runs
    (each on its own device and in its own dtype) with the same files.
    The snapshots span `window_hours`, which the run must stay inside.
    Returns (wrapper module, nudger)."""
    from .. import wrapper
    from .nudging import nudger_from_config
    from .steppers import NudgingConfig

    rundir = os.path.join(root, "run")
    if not os.path.isdir(os.path.join(rundir, "INPUT")):
        write_input(rundir, n, seed)
    wrapper.initialize(model_config(n, rundir, dtype), device=device)
    reference = os.path.join(root, "reference")
    if not os.path.isdir(reference):
        st = wrapper.get_state([names.TEMP, names.SPHUM])
        write_snapshots(reference, st[names.TEMP].values,
                        st[names.SPHUM].values, wrapper.get_model().time,
                        window_hours)
    return wrapper, nudger_from_config(NudgingConfig(
        timescale_hours=dict(TIMESCALE_HOURS), restarts_path=reference))
