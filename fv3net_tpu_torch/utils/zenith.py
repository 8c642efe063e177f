"""Solar zenith angle (vcm/calc/_zenith_angle.py:242 equivalent)."""

from __future__ import annotations

import datetime

import numpy as np


def _days_from_2000(time: datetime.datetime) -> float:
    ref = datetime.datetime(2000, 1, 1, 12, 0, 0)
    return (time - ref).total_seconds() / 86400.0


def _greenwich_mean_sidereal_time(time) -> float:
    jul = _days_from_2000(time)
    theta = 280.46061837 + 360.98564736629 * jul
    return np.deg2rad(theta % 360.0)


def _sun_declination_ra(time):
    jd = _days_from_2000(time)
    g = np.deg2rad((357.529 + 0.98560028 * jd) % 360.0)
    q = (280.459 + 0.98564736 * jd) % 360.0
    lam = np.deg2rad(
        (q + 1.915 * np.sin(g) + 0.020 * np.sin(2 * g)) % 360.0
    )
    e = np.deg2rad(23.439 - 0.00000036 * jd)
    dec = np.arcsin(np.sin(e) * np.sin(lam))
    ra = np.arctan2(np.cos(e) * np.sin(lam), np.cos(lam))
    return dec, ra


def cos_zenith_angle(time: datetime.datetime, lon_deg, lat_deg):
    """Cosine of solar zenith angle at `time` for lon/lat in degrees."""
    lon = np.deg2rad(np.asarray(lon_deg))
    lat = np.deg2rad(np.asarray(lat_deg))
    dec, ra = _sun_declination_ra(time)
    gmst = _greenwich_mean_sidereal_time(time)
    local_sidereal = gmst + lon
    hour_angle = local_sidereal - ra
    return np.sin(lat) * np.sin(dec) + np.cos(lat) * np.cos(dec) * np.cos(
        hour_angle
    )
