"""Model-state mapping with derived variables and mass-conserving set
(a copy of the JAX package's ``runtime/derived_state.py``: numpy on the
host copies ``.values`` of the model's tensors).

The DerivedFV3State/MergedState semantics of the reference
(runtime/derived_state.py:15-209): a dict-like view over the wrapper's
state with lazily-derived entries, a `time` property, plain item
assignment routed to set_state, and `update_mass_conserving` routed to
the wrapper's mass-conserving setter.  MergedState adds a Python-side
overlay for variables the model does not own.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, MutableMapping

import numpy as np

from ..util.quantity import Quantity
from . import names


class DerivedMapping:
    """Registry of derived variables computed on demand from a state
    mapping (vcm.DerivedMapping semantics, vcm/derived_mapping.py:8)."""

    _register: Dict[str, Callable] = {}

    def __init__(self, mapper):
        self._mapper = mapper

    @classmethod
    def register(cls, name: str):
        def wrap(fn):
            cls._register[name] = fn
            return fn

        return wrap

    def __getitem__(self, key: str) -> Quantity:
        # state values win over registered derivations: a variable the
        # model already owns (e.g. "surface_pressure") must not be
        # shadowed by a recomputation (vcm.DerivedMapping likewise
        # falls back to the dataset first)
        try:
            return self._mapper[key]
        except KeyError:
            if key in self._register:
                return self._register[key](self)
            raise

    def keys(self):
        return set(self._mapper.keys()) | set(self._register)

    def dataset(self, keys):
        return {k: self[k] for k in keys}


@DerivedMapping.register("cos_zenith_angle")
def _cos_zenith(dm: DerivedMapping) -> Quantity:
    from ..utils.zenith import cos_zenith_angle

    time = dm["time"]
    lon = dm["longitude"]
    lat = dm["latitude"]
    cz = cos_zenith_angle(time, np.rad2deg(lon.values),
                          np.rad2deg(lat.values))
    return Quantity(cz, lon.dims, "")


@DerivedMapping.register("evaporation")
def _evaporation(dm: DerivedMapping) -> Quantity:
    lhf = dm["latent_heat_flux"]
    from ..constants import LATENT_HEAT_VAPORIZATION

    return Quantity(
        lhf.values / LATENT_HEAT_VAPORIZATION, lhf.dims, "kg/m**2/s"
    )


# --- the vcm.DerivedMapping registered-variable set -------------------
# (vcm/derived_mapping.py:8-38 registers ~28 names; those expressible
# from this framework's canonical state are reproduced here)


def _delp(dm):
    return dm[names.DELP]


@DerivedMapping.register("pressure")
def _pressure(dm: DerivedMapping) -> Quantity:
    from ..utils.thermo import pressure_at_midpoint_log

    delp = _delp(dm)
    return Quantity(
        np.asarray(pressure_at_midpoint_log(delp.values)),
        delp.dims, "Pa",
    )


@DerivedMapping.register("pressure_at_interface")
def _pressure_interface(dm: DerivedMapping) -> Quantity:
    from ..utils.thermo import pressure_interface

    delp = _delp(dm)
    # the interface axis has nz+1 entries: give it its own dim name
    dims = tuple(
        "z_interface" if d == "z" else d for d in delp.dims
    )
    return Quantity(
        np.asarray(pressure_interface(delp.values)), dims, "Pa"
    )


@DerivedMapping.register("surface_pressure")
def _surface_pressure(dm: DerivedMapping) -> Quantity:
    from ..utils.thermo import surface_pressure_from_delp

    delp = _delp(dm)
    ps = np.asarray(surface_pressure_from_delp(delp.values))
    dims = delp.dims[:-3] + delp.dims[-2:]
    return Quantity(ps, dims, "Pa")


@DerivedMapping.register("relative_humidity")
def _relative_humidity(dm: DerivedMapping) -> Quantity:
    from ..utils.thermo import (
        pressure_at_midpoint_log,
        relative_humidity_from_pressure,
    )

    T = dm[names.TEMP]
    q = dm[names.SPHUM]
    p = pressure_at_midpoint_log(_delp(dm).values)
    rh = np.asarray(
        relative_humidity_from_pressure(T.values, q.values, p)
    )
    return Quantity(rh, T.dims, "")


@DerivedMapping.register("potential_temperature")
def _theta(dm: DerivedMapping) -> Quantity:
    from ..utils.thermo import (
        potential_temperature,
        pressure_at_midpoint_log,
    )

    T = dm[names.TEMP]
    p = pressure_at_midpoint_log(_delp(dm).values)
    return Quantity(
        np.asarray(potential_temperature(p, T.values)), T.dims, "K"
    )


@DerivedMapping.register("virtual_temperature")
def _tv(dm: DerivedMapping) -> Quantity:
    from ..utils.thermo import virtual_temperature

    T = dm[names.TEMP]
    q = dm[names.SPHUM]
    return Quantity(
        np.asarray(virtual_temperature(T.values, q.values)), T.dims,
        "K",
    )


@DerivedMapping.register("total_water")
def _total_water(dm: DerivedMapping) -> Quantity:
    q = dm[names.SPHUM]
    qc = dm[names.CLOUD]
    return Quantity(q.values + qc.values, q.dims, "kg/kg")


@DerivedMapping.register("column_integrated_water")
def _ciw(dm: DerivedMapping) -> Quantity:
    from ..utils.thermo import mass_integrate

    tw = dm["total_water"]
    delp = _delp(dm)
    col = np.asarray(mass_integrate(tw.values, delp.values))
    dims = delp.dims[:-3] + delp.dims[-2:]
    return Quantity(col, dims, "kg/m**2")


@DerivedMapping.register("water_vapor_path")
def _wvp(dm: DerivedMapping) -> Quantity:
    from ..utils.thermo import mass_integrate

    q = dm[names.SPHUM]
    delp = _delp(dm)
    col = np.asarray(mass_integrate(q.values, delp.values))
    dims = delp.dims[:-3] + delp.dims[-2:]
    return Quantity(col, dims, "kg/m**2")


@DerivedMapping.register("wind_speed")
def _wind_speed(dm: DerivedMapping) -> Quantity:
    u = dm[names.EASTWARD_WIND]
    v = dm[names.NORTHWARD_WIND]
    return Quantity(
        np.sqrt(u.values ** 2 + v.values ** 2), u.dims, "m/s"
    )


@DerivedMapping.register("is_land")
def _is_land(dm: DerivedMapping) -> Quantity:
    m = dm[names.MASK]
    return Quantity(
        np.asarray(np.rint(m.values) == 1.0), m.dims, ""
    )


@DerivedMapping.register("is_sea")
def _is_sea(dm: DerivedMapping) -> Quantity:
    m = dm[names.MASK]
    return Quantity(
        np.asarray(np.rint(m.values) == 0.0), m.dims, ""
    )


@DerivedMapping.register("is_sea_ice")
def _is_sea_ice(dm: DerivedMapping) -> Quantity:
    m = dm[names.MASK]
    return Quantity(
        np.asarray(np.rint(m.values) == 2.0), m.dims, ""
    )


@DerivedMapping.register("net_heating_due_to_machine_learning")
def _net_heating_ml(dm: DerivedMapping) -> Quantity:
    from ..constants import CP_AIR
    from ..utils.thermo import mass_integrate

    dq1 = dm["dQ1"]
    delp = _delp(dm)
    col = CP_AIR * np.asarray(
        mass_integrate(dq1.values, delp.values)
    )
    dims = delp.dims[:-3] + delp.dims[-2:]
    return Quantity(col, dims, "W/m**2")


@DerivedMapping.register("net_moistening_due_to_machine_learning")
def _net_moistening_ml(dm: DerivedMapping) -> Quantity:
    from ..utils.thermo import mass_integrate

    dq2 = dm["dQ2"]
    delp = _delp(dm)
    col = np.asarray(mass_integrate(dq2.values, delp.values))
    dims = delp.dims[:-3] + delp.dims[-2:]
    return Quantity(col, dims, "kg/m**2/s")


@DerivedMapping.register("latent_heat_flux_from_evaporation")
def _lhf_from_evap(dm: DerivedMapping) -> Quantity:
    from ..constants import LATENT_HEAT_VAPORIZATION

    e = dm["evaporation"]
    return Quantity(
        e.values * LATENT_HEAT_VAPORIZATION, e.dims, "W/m**2"
    )


# --- remaining vcm.DerivedMapping registrations (parity with the
# reference's 28-name registry, vcm/derived_mapping.py:114-395) -------


def _rotate_winds(dm: DerivedMapping, xname: str, yname: str):
    """D-grid (x, y) components -> centered (eastward, northward)
    using the rotation-coefficient fields carried in the state
    (derived_mapping.py:129-140 _rotate)."""
    from ..utils.rotate import center_and_rotate_xy_winds

    matrix = {
        k: np.asarray(dm[k].values)
        for k in (
            "eastward_wind_u_coeff", "eastward_wind_v_coeff",
            "northward_wind_u_coeff", "northward_wind_v_coeff",
        )
    }
    x = dm[xname]
    east, north = center_and_rotate_xy_winds(
        matrix, np.asarray(x.values), np.asarray(dm[yname].values)
    )
    dims = x.dims[:-2] + ("y", "x")
    return (
        Quantity(east, dims, "m/s"),
        Quantity(north, dims, "m/s"),
    )


@DerivedMapping.register("eastward_wind")
def _eastward_wind(dm: DerivedMapping) -> Quantity:
    return _rotate_winds(dm, "x_wind", "y_wind")[0]


@DerivedMapping.register("northward_wind")
def _northward_wind(dm: DerivedMapping) -> Quantity:
    return _rotate_winds(dm, "x_wind", "y_wind")[1]


@DerivedMapping.register("dQu")
def _dqu(dm: DerivedMapping) -> Quantity:
    return _rotate_winds(dm, "dQxwind", "dQywind")[0]


@DerivedMapping.register("dQv")
def _dqv(dm: DerivedMapping) -> Quantity:
    return _rotate_winds(dm, "dQxwind", "dQywind")[1]


@DerivedMapping.register("dQu_parallel_to_eastward_wind")
def _dqu_parallel(dm: DerivedMapping) -> Quantity:
    # NOTE: sign(u / du) (NaN where du == 0 and u == 0) reproduces the
    # reference's exact formula (derived_mapping.py:170) — data-contract
    # parity over numerical tidiness
    u, du = dm["eastward_wind"], dm["dQu"]
    sign = np.sign(np.asarray(u.values) / np.asarray(du.values))
    return Quantity(
        sign * np.abs(np.asarray(du.values)), du.dims, "m/s/s"
    )


@DerivedMapping.register("dQv_parallel_to_northward_wind")
def _dqv_parallel(dm: DerivedMapping) -> Quantity:
    v, dv = dm["northward_wind"], dm["dQv"]
    sign = np.sign(np.asarray(v.values) / np.asarray(dv.values))
    return Quantity(
        sign * np.abs(np.asarray(dv.values)), dv.dims, "m/s/s"
    )


@DerivedMapping.register(
    "horizontal_wind_tendency_parallel_to_horizontal_wind"
)
def _wind_tendency_parallel(dm: DerivedMapping) -> Quantity:
    u = np.asarray(dm["eastward_wind"].values)
    v = np.asarray(dm["northward_wind"].values)
    du = np.asarray(dm["dQu"].values)
    dv = np.asarray(dm["dQv"].values)
    # NOTE: np.linalg.norm((u, v)) is a single Frobenius norm over the
    # WHOLE stacked field — grid-size-dependent scaling — but it is
    # exactly what the reference computes (derived_mapping.py:186-190);
    # kept for data-contract parity
    proj = (u * du + v * dv) / np.linalg.norm((u, v))
    return Quantity(proj, dm["dQu"].dims, "m/s/s")


@DerivedMapping.register("net_shortwave_sfc_flux_derived")
def _net_sw_sfc_derived(dm: DerivedMapping) -> Quantity:
    albedo = dm["surface_diffused_shortwave_albedo"]
    down = dm[
        "override_for_time_adjusted_total_sky_downward_shortwave_"
        "flux_at_surface"
    ]
    return Quantity(
        (1.0 - np.asarray(albedo.values)) * np.asarray(down.values),
        down.dims, "W/m**2",
    )


@DerivedMapping.register("downward_shortwave_sfc_flux_via_transmissivity")
def _down_sw_via_trans(dm: DerivedMapping) -> Quantity:
    toa = dm["total_sky_downward_shortwave_flux_at_top_of_atmosphere"]
    trans = dm["shortwave_transmissivity_of_atmospheric_column"]
    return Quantity(
        np.asarray(trans.values) * np.asarray(toa.values),
        toa.dims, "W/m**2",
    )


@DerivedMapping.register("net_shortwave_sfc_flux_via_transmissivity")
def _net_sw_via_trans(dm: DerivedMapping) -> Quantity:
    albedo = dm["surface_diffused_shortwave_albedo"]
    down = dm["downward_shortwave_sfc_flux_via_transmissivity"]
    return Quantity(
        (1.0 - np.asarray(albedo.values)) * np.asarray(down.values),
        down.dims, "W/m**2",
    )


@DerivedMapping.register("pQ1")
def _pq1(dm: DerivedMapping) -> Quantity:
    delp = _delp(dm)
    return Quantity(np.zeros_like(delp.values), delp.dims, "K/s")


@DerivedMapping.register("pQ2")
def _pq2(dm: DerivedMapping) -> Quantity:
    delp = _delp(dm)
    return Quantity(
        np.zeros_like(delp.values), delp.dims, "kg/kg/s"
    )


@DerivedMapping.register("Q1")
def _q1(dm: DerivedMapping) -> Quantity:
    pq1 = dm["pQ1"]
    try:
        dq1 = dm["dQ1"]
    except KeyError:
        return pq1
    return Quantity(
        np.asarray(pq1.values) + np.asarray(dq1.values),
        pq1.dims, "K/s",
    )


@DerivedMapping.register("Q2")
def _q2(dm: DerivedMapping) -> Quantity:
    pq2 = dm["pQ2"]
    try:
        dq2 = dm["dQ2"]
    except KeyError:
        return pq2
    return Quantity(
        np.asarray(pq2.values) + np.asarray(dq2.values),
        pq2.dims, "kg/kg/s",
    )


@DerivedMapping.register("internal_energy")
def _internal_energy(dm: DerivedMapping) -> Quantity:
    from ..constants import CV_AIR

    t = dm[names.TEMP]
    return Quantity(CV_AIR * np.asarray(t.values), t.dims, "J/kg")


def _column_heating_isochoric(dm, tendency_name):
    """cv/g integral of a temperature tendency (vcm
    column_integrated_heating_from_isochoric_transition)."""
    from ..constants import CV_AIR, GRAV

    dt = dm[tendency_name]
    delp = _delp(dm)
    col = (CV_AIR / GRAV) * (
        np.asarray(dt.values) * np.asarray(delp.values)
    ).sum(axis=-3)
    dims = delp.dims[:-3] + delp.dims[-2:]
    return Quantity(col, dims, "W/m**2")


def _column_moistening(dm, tendency_name):
    """g^-1 integral of a humidity tendency, in mm/day (vcm
    minus_column_integrated_moistening, sign flipped back)."""
    from ..constants import GRAV

    dq = dm[tendency_name]
    delp = _delp(dm)
    kg_m2_s = (
        np.asarray(dq.values) * np.asarray(delp.values)
    ).sum(axis=-3) / GRAV
    dims = delp.dims[:-3] + delp.dims[-2:]
    return Quantity(kg_m2_s * 86400.0, dims, "mm/day")


@DerivedMapping.register("column_integrated_dQ1")
def _col_dq1(dm: DerivedMapping) -> Quantity:
    return _column_heating_isochoric(dm, "dQ1")


@DerivedMapping.register("column_integrated_dQ2")
def _col_dq2(dm: DerivedMapping) -> Quantity:
    return _column_moistening(dm, "dQ2")


@DerivedMapping.register("column_integrated_Q1")
def _col_q1(dm: DerivedMapping) -> Quantity:
    return _column_heating_isochoric(dm, "Q1")


@DerivedMapping.register("column_integrated_Q2")
def _col_q2(dm: DerivedMapping) -> Quantity:
    return _column_moistening(dm, "Q2")


@DerivedMapping.register("upward_heat_flux_at_surface")
def _upward_heat_flux_sfc(dm: DerivedMapping) -> Quantity:
    sw_up = dm["total_sky_upward_shortwave_flux_at_surface"]
    lw_up = dm["total_sky_upward_longwave_flux_at_surface"]
    shf = dm["sensible_heat_flux"]
    return Quantity(
        np.asarray(sw_up.values)
        + np.asarray(lw_up.values)
        + np.asarray(shf.values),
        sw_up.dims, "W/m**2",
    )


def _incloud(dm, condensate_name, climit1=1.0e-3, climit2=5.0e-2):
    """GFS radiation_clouds.f condensate normalization
    (vcm/calc/clouds.py gridcell_to_incloud_condensate): in-cloud
    condensate = gridcell-mean / max(cloud_fraction, climit2), except
    untouched where cloud_fraction <= climit1."""
    cf = np.asarray(dm["cloud_amount"].values)
    q = dm[condensate_name]
    qv = np.asarray(q.values)
    scaled = qv / np.maximum(cf, climit2)
    return Quantity(
        np.where(cf <= climit1, qv, scaled), q.dims, "kg/kg"
    )


@DerivedMapping.register("incloud_water_mixing_ratio")
def _incloud_water(dm: DerivedMapping) -> Quantity:
    return _incloud(dm, "cloud_water_mixing_ratio")


@DerivedMapping.register("incloud_ice_mixing_ratio")
def _incloud_ice(dm: DerivedMapping) -> Quantity:
    return _incloud(dm, "cloud_ice_mixing_ratio")


class DerivedModelState(MutableMapping):
    """Dict-like wrapper-state view (DerivedFV3State equivalent)."""

    def __init__(self, wrapper):
        self._wrapper = wrapper

    @property
    def time(self):
        return self._wrapper.get_state(["time"])["time"]

    def __getitem__(self, key: str) -> Quantity:
        if key == "time":
            return self.time
        return self._wrapper.get_state([key])[key]

    def __setitem__(self, key: str, value: Quantity):
        self._wrapper.set_state({key: value})

    def __delitem__(self, key):
        raise NotImplementedError

    def __iter__(self):
        yield from self.keys()

    def __len__(self):
        return len(list(self.keys()))

    def keys(self):
        props = (
            self._wrapper._properties.DYNAMICS_PROPERTIES
            + self._wrapper._properties.PHYSICS_PROPERTIES
        )
        try:  # every active tracer (6-species GFDL set included)
            tracers = list(self._wrapper.get_tracer_metadata())
        except Exception:
            tracers = [names.SPHUM, names.CLOUD]
        return [p["name"] for p in props] + tracers + [
            names.X_WIND,
            names.Y_WIND,
            names.EASTWARD_WIND,
            names.NORTHWARD_WIND,
            names.AREA,
            "latitude",
            "longitude",
        ]

    def update(self, other: Mapping[str, Quantity]):  # type: ignore
        self._wrapper.set_state(dict(other))

    def update_mass_conserving(self, other: Mapping[str, Quantity]):
        self._wrapper.set_state_mass_conserving(dict(other))


class MergedState(MutableMapping):
    """Union of the model state and a Python-side overlay
    (runtime/derived_state.py:148)."""

    def __init__(self, model_state: DerivedModelState, overlay=None):
        self.model = model_state
        self.overlay: Dict[str, Quantity] = dict(overlay or {})

    @property
    def time(self):
        return self.model.time

    def __getitem__(self, key):
        if key in self.overlay:
            return self.overlay[key]
        return self.model[key]

    def __setitem__(self, key, value):
        try:
            self.model[key] = value
        except KeyError:
            self.overlay[key] = value

    def __delitem__(self, key):
        del self.overlay[key]

    def keys(self):
        return list(self.model.keys()) + list(self.overlay.keys())

    def __iter__(self):
        yield from self.keys()

    def __len__(self):
        return len(self.keys())

    def update_mass_conserving(self, other):
        model_part = {}
        for k, v in other.items():
            if k in self.model.keys():
                model_part[k] = v
            else:
                self.overlay[k] = v
        if model_part:
            self.model.update_mass_conserving(model_part)
