"""Fortran (FMS) restart-file ingestion and emission.

The reference initializes runs from FV3GFS restart directories: per-tile
NetCDF classic files in the four categories ``fv_core.res``,
``fv_tracer.res``, ``fv_srf_wnd.res`` and ``sfc_data``
(`external/vcm/vcm/cubedsphere/constants.py:32` RESTART_CATEGORIES),
walked out of INPUT/ and RESTART/ by
`external/vcm/vcm/fv3_restarts/_rundir.py:23-39`, with raw FMS axis
names (xaxis_1, yaxis_2, zaxis_1 …) renamed per category onto the
diagnostic grid names and each variable's dims imposed from a schema
registry (`external/vcm/vcm/fv3_restarts/schema_registry.py`).  Times
come from ``coupler.res`` (`_rundir.py:208-216`).

This module (a copy of the JAX package's ``io/restarts.py``, its state
from the port's ``DycoreState``) reproduces that contract on the in-house
NetCDF3 codec (``io/netcdf3.py``): open a run directory into a dict of
6-tile-stacked Quantities with standardized dims, convert to/from the
dycore prognostic state (temperature <-> potential temperature,
restart ``DZ``/``W`` <-> delz/w), and write restart directories other
FV3 tooling can read back.  Everything here is host numpy: the
temperature conversion runs in float64 on the host, and the state it
builds holds float32 numpy arrays, which the wrapper moves to the
model's device.  ``restarts_from_state`` takes tensors on any device.
"""

from __future__ import annotations

import datetime
import os
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from ..util.quantity import Quantity
from . import netcdf3


def _host(x, dtype=None) -> np.ndarray:
    """A tensor (on any device) or an array as a host array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


RESTART_CATEGORIES = ["fv_core.res", "sfc_data", "fv_tracer.res", "fv_srf_wnd.res"]

COORD_X_CENTER = "grid_xt"
COORD_X_OUTER = "grid_x"
COORD_Y_CENTER = "grid_yt"
COORD_Y_OUTER = "grid_y"
COORD_Z_CENTER = "pfull"
COORD_Z_SOIL = "soil_layer"

# per-category FMS axis-name -> diagnostic-name maps
# (vcm/cubedsphere/constants.py:8-19: FV_CORE_* / FV_TRACER_* / SFC_DATA_*)
_CATEGORY_DIM_RENAMES: Dict[str, Dict[str, str]] = {
    "fv_core.res": {
        "xaxis_1": COORD_X_CENTER,
        "yaxis_2": COORD_Y_CENTER,
        "xaxis_2": COORD_X_OUTER,
        "yaxis_1": COORD_Y_OUTER,
        "zaxis_1": COORD_Z_CENTER,
    },
    "fv_tracer.res": {
        "xaxis_1": COORD_X_CENTER,
        "yaxis_1": COORD_Y_CENTER,
        "zaxis_1": COORD_Z_CENTER,
    },
    "fv_srf_wnd.res": {
        "xaxis_1": COORD_X_CENTER,
        "yaxis_1": COORD_Y_CENTER,
    },
    "sfc_data": {
        "xaxis_1": COORD_X_CENTER,
        "yaxis_1": COORD_Y_CENTER,
        "zaxis_1": COORD_Z_SOIL,
    },
}

# the category each prognostic variable is written into, with its
# restart-file name and dims (schema_registry.py REGISTRY subset the
# dycore needs; surface fields flow through untouched)
_CORE_3D = (COORD_Z_CENTER, COORD_Y_CENTER, COORD_X_CENTER)
_CATEGORY_VARS = {
    "fv_core.res": {
        "u": (COORD_Z_CENTER, COORD_Y_OUTER, COORD_X_CENTER),
        "v": (COORD_Z_CENTER, COORD_Y_CENTER, COORD_X_OUTER),
        "W": _CORE_3D,
        "DZ": _CORE_3D,
        "T": _CORE_3D,
        "delp": _CORE_3D,
        "phis": (COORD_Y_CENTER, COORD_X_CENTER),
    },
    "fv_srf_wnd.res": {
        "u_srf": (COORD_Y_CENTER, COORD_X_CENTER),
        "v_srf": (COORD_Y_CENTER, COORD_X_CENTER),
    },
}
TRACER_NAMES = [
    "sphum", "liq_wat", "rainwat", "ice_wat", "snowwat", "graupel",
    "o3mr", "cld_amt",
]

_TILE_RE = re.compile(
    r"^(?P<prefix>(?:\d{8}\.\d{6}\.)?)(?P<category>"
    + "|".join(re.escape(c) for c in RESTART_CATEGORIES)
    + r")\.tile(?P<tile>[1-6])\.nc$"
)


def _is_restart_file(fname: str) -> Optional[re.Match]:
    return _TILE_RE.match(fname)


def yield_restart_files(rundir: str):
    """Yield (file_prefix, category, tile, path) like _rundir.py:23-39.

    file_prefix is "INPUT", "RESTART", or "RESTART/<timestamp>" for
    intermediate restarts.
    """
    for root, _, files in sorted(os.walk(rundir)):
        rel = os.path.relpath(root, rundir)
        for fname in sorted(files):
            m = _is_restart_file(fname)
            if not m:
                continue
            ts = m.group("prefix").rstrip(".")
            prefix = rel if not ts else os.path.join(rel, ts)
            yield (
                prefix,
                m.group("category"),
                int(m.group("tile")) - 1,
                os.path.join(root, fname),
            )


def _standardize(var: netcdf3.Variable, category: str) -> Quantity:
    ren = _CATEGORY_DIM_RENAMES.get(category, {})
    dims = tuple(ren.get(d, d) for d in var.dims)
    data = var.data
    if dims[:1] == ("Time",):  # drop the singleton FMS Time axis
        data = data[0]
        dims = dims[1:]
    units = var.attrs.get("units", "")
    if isinstance(units, bytes):
        units = units.decode()
    return Quantity(np.asarray(data), dims, str(units).strip())


def open_restarts(
    rundir: str, prefix: Optional[str] = None
) -> Dict[str, Dict[str, Quantity]]:
    """Open all restart files under a run directory.

    Returns {file_prefix: {variable_name: Quantity}} with tiles stacked
    on a leading "tile" dim and dims standardized to diagnostic names
    (the single-prefix analogue of `fv3_restarts/io.py:open_restarts`,
    which stacks on [file_prefix, tile]).
    """
    grouped: Dict[Tuple[str, str], Dict[int, str]] = {}
    for pfx, category, tile, path in yield_restart_files(rundir):
        if prefix is not None and pfx != prefix:
            continue
        grouped.setdefault((pfx, category), {})[tile] = path

    out: Dict[str, Dict[str, Quantity]] = {}
    for (pfx, category), tiles in grouped.items():
        if sorted(tiles) != list(range(6)):
            raise ValueError(
                f"{category} under {pfx!r} has tiles "
                f"{sorted(t + 1 for t in tiles)}, expected 1..6"
            )
        per_tile = [netcdf3.read(tiles[t]) for t in range(6)]
        dest = out.setdefault(pfx, {})
        for name in per_tile[0].variables:
            if name in per_tile[0].dimensions:
                continue  # coordinate variables
            qs = [_standardize(ds.variables[name], category) for ds in per_tile]
            stacked = np.stack([q.values for q in qs])
            dest[name] = Quantity(
                stacked, ("tile",) + qs[0].dims, qs[0].units
            )
    return out


def read_coupler_res(path: str) -> datetime.datetime:
    """Parse the current model time from an FMS coupler.res
    (_rundir.py:208-216: the third line's first six ints)."""
    with open(path) as f:
        lines = f.readlines()
    try:
        y, mo, d, h, mi, s = [int(tok) for tok in lines[2].split()[:6]]
        return datetime.datetime(y, mo, d, h, mi, s)
    except (IndexError, ValueError) as e:
        raise ValueError(f"{path} has no valid current model time") from e


def write_coupler_res(
    path: str,
    time: datetime.datetime,
    initial_time: Optional[datetime.datetime] = None,
) -> None:
    init = initial_time or time
    with open(path, "w") as f:
        f.write("     2        (Calendar: no_calendar=0, thirty_day_months=1, "
                "julian=2, gregorian=3, noleap=4)\n")
        f.write(
            f"  {init.year:>5} {init.month:>3} {init.day:>3} "
            f"{init.hour:>3} {init.minute:>3} {init.second:>3}"
            "        Model start time:   year, month, day, hour, minute, second\n"
        )
        f.write(
            f"  {time.year:>5} {time.month:>3} {time.day:>3} "
            f"{time.hour:>3} {time.minute:>3} {time.second:>3}"
            "        Current model time: year, month, day, hour, minute, second\n"
        )


# ----------------------------------------------------------------------
# dycore state <-> restart fields
# ----------------------------------------------------------------------


def state_from_restarts(
    fields: Mapping[str, Quantity], ptop: float
) -> Tuple[object, np.ndarray]:
    """Build a DycoreState from opened restart fields.

    Restart fields hold temperature ``T``; the dycore carries potential
    temperature, so T is converted with the restart's own hydrostatic
    pressures (delp integrated down from ptop).  ``DZ``/``W`` map to
    delz/w (FV3's delz<0 convention preserved).  Tracers stack in
    TRACER_NAMES order; absent tracers are zero-filled only if sphum
    exists.  Returns (state, phis).
    """
    from ..constants import KAPPA, REFERENCE_SURFACE_PRESSURE
    from ..dycore.hydro import DycoreState

    delp = fields["delp"].values.astype(np.float64)
    pe = ptop + np.concatenate(
        [np.zeros_like(delp[:, :1]), np.cumsum(delp, axis=1)], axis=1
    )
    pk = (pe / REFERENCE_SURFACE_PRESSURE) ** KAPPA
    # layer-mean Exner consistent with the remap definition
    pkz = (pk[:, 1:] - pk[:, :-1]) / (
        KAPPA * (np.log(pe[:, 1:]) - np.log(np.maximum(pe[:, :-1], 1e-10)))
    )
    pt = fields["T"].values / pkz

    tracers = [n for n in TRACER_NAMES if n in fields]
    q = (
        np.stack([fields[n].values for n in tracers])
        if tracers
        else None
    )
    w = fields["W"].values if "W" in fields else None
    delz = fields["DZ"].values if "DZ" in fields else None
    phis = (
        fields["phis"].values
        if "phis" in fields
        else np.zeros(delp.shape[:1] + delp.shape[2:])
    )
    f32 = np.float32
    state = DycoreState(
        delp=delp.astype(f32),
        pt=pt.astype(f32),
        u=fields["u"].values.astype(f32),
        v=fields["v"].values.astype(f32),
        q=None if q is None else q.astype(f32),
        w=None if w is None else w.astype(f32),
        delz=None if delz is None else delz.astype(f32),
    )
    return state, phis.astype(f32)


def restarts_from_state(
    state, phis: np.ndarray, ptop: float
) -> Dict[str, Quantity]:
    """Inverse of state_from_restarts (pt -> T with the same pkz)."""
    from ..constants import KAPPA, REFERENCE_SURFACE_PRESSURE

    delp = _host(state.delp, np.float64)
    pe = ptop + np.concatenate(
        [np.zeros_like(delp[:, :1]), np.cumsum(delp, axis=1)], axis=1
    )
    pk = (pe / REFERENCE_SURFACE_PRESSURE) ** KAPPA
    pkz = (pk[:, 1:] - pk[:, :-1]) / (
        KAPPA * (np.log(pe[:, 1:]) - np.log(np.maximum(pe[:, :-1], 1e-10)))
    )
    t3 = ("tile",) + _CORE_3D
    out = {
        "delp": Quantity(_host(state.delp), t3, "Pa"),
        "T": Quantity(
            _host(state.pt, np.float64) * pkz, t3, "K"
        ),
        "u": Quantity(
            _host(state.u),
            ("tile", COORD_Z_CENTER, COORD_Y_OUTER, COORD_X_CENTER), "m/s",
        ),
        "v": Quantity(
            _host(state.v),
            ("tile", COORD_Z_CENTER, COORD_Y_CENTER, COORD_X_OUTER), "m/s",
        ),
        "phis": Quantity(
            _host(phis), ("tile", COORD_Y_CENTER, COORD_X_CENTER),
            "m**2/s**2",
        ),
    }
    if state.w is not None:
        out["W"] = Quantity(_host(state.w), t3, "m/s")
    if state.delz is not None:
        out["DZ"] = Quantity(_host(state.delz), t3, "m")
    if state.q is not None:
        for i in range(state.q.shape[0]):
            name = TRACER_NAMES[i] if i < len(TRACER_NAMES) else f"tracer{i}"
            out[name] = Quantity(_host(state.q[i]), t3, "kg/kg")
    return out


def _invert(ren: Dict[str, str]) -> Dict[str, str]:
    return {v: k for k, v in ren.items()}


def write_restarts(
    fields: Mapping[str, Quantity],
    rundir: str,
    time: Optional[datetime.datetime] = None,
    subdir: str = "RESTART",
) -> None:
    """Write fields as per-tile FMS restart files under rundir/subdir.

    Variables route to their category (fv_core.res / fv_tracer.res /
    fv_srf_wnd.res; everything 2D and unknown goes to sfc_data), dims
    are renamed back to the per-category FMS axis names, a singleton
    Time record dim is added, and tiles split into .tile{1..6}.nc —
    the layout yield_restart_files / the reference's walker expect.
    """
    outdir = os.path.join(rundir, subdir)
    os.makedirs(outdir, exist_ok=True)

    by_cat: Dict[str, Dict[str, Quantity]] = {c: {} for c in RESTART_CATEGORIES}
    for name, q in fields.items():
        if name in _CATEGORY_VARS["fv_core.res"]:
            by_cat["fv_core.res"][name] = q
        elif name in _CATEGORY_VARS["fv_srf_wnd.res"]:
            by_cat["fv_srf_wnd.res"][name] = q
        elif name in TRACER_NAMES:
            by_cat["fv_tracer.res"][name] = q
        else:
            by_cat["sfc_data"][name] = q

    for category, group in by_cat.items():
        if not group:
            continue
        inv = _invert(_CATEGORY_DIM_RENAMES[category])
        for tile in range(6):
            dims: Dict[str, Optional[int]] = {"Time": None}
            variables: Dict[str, netcdf3.Variable] = {}
            for name, q in group.items():
                arr = q.values[tile][None]  # add Time record dim
                fms_dims = ("Time",) + tuple(
                    inv.get(d, d) for d in q.dims[1:]
                )
                for d, s in zip(fms_dims[1:], arr.shape[1:]):
                    prev = dims.get(d)
                    if prev is not None and prev != s:
                        raise ValueError(
                            f"{category}: dim {d} is {s} for {name} "
                            f"but {prev} elsewhere"
                        )
                    dims[d] = s
                variables[name] = netcdf3.Variable(
                    np.asarray(arr, np.float64), fms_dims,
                    {"units": q.units, "long_name": name},
                )
            ds = netcdf3.Dataset(dims, variables, {"filename": category})
            netcdf3.write(
                os.path.join(outdir, f"{category}.tile{tile + 1}.nc"), ds
            )
    if time is not None:
        write_coupler_res(os.path.join(outdir, "coupler.res"), time)
