"""The port's vertical interpolation (``ops.remap.interpolate_columns``,
``utils.interpolate``) against the JAX package's, float64 on the CPU.

Tolerance.  Both packages evaluate the same telescoping sum of the same
float64 products; only the order of the sum over the source levels may
differ (XLA's reduction against torch's), so the results agree to
RTOL 1e-12 of each column's scale.  At the bounds the semantics hold in
both: a target on source level k returns y[k] (the clipped fractions are
exactly 1 below it and 0 above, so the sum telescopes to y[k] up to the
rounding of its k terms: the same RTOL), the last source level is in
range, and targets outside get the fill value.
``interpolate_unstructured`` is the same host code in both: equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu.ops import remap as jremap
from fv3net_tpu.utils import interpolate as jint
from fv3net_tpu_torch.ops import remap as tremap
from fv3net_tpu_torch.utils import interpolate as tint

torch.set_num_threads(1)

RTOL = 1e-12


def _columns(seed, n_in=9, cols=(4, 5)):
    rng = np.random.RandomState(seed)
    x = np.cumsum(0.1 + rng.rand(n_in, *cols), axis=0)
    y = rng.randn(n_in, *cols)
    return x, y


def _both(xp, x, y, fill=np.nan):
    want = np.asarray(jremap.interpolate_columns(
        jnp.asarray(xp), jnp.asarray(x), jnp.asarray(y), fill_value=fill))
    got = tremap.interpolate_columns(
        torch.as_tensor(xp), torch.as_tensor(x), torch.as_tensor(y),
        fill_value=fill).numpy()
    return got, want


def _close(got, want, scale):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0,
                               atol=RTOL * scale)


@pytest.mark.parametrize("case", [
    "on_levels", "last_level", "below", "above", "seeded",
])
def test_interpolate_columns_bounds(case):
    """Targets on the source levels, at the last level, outside the
    range on either side, and seeded targets inside it."""
    x, y = _columns(1)
    rng = np.random.RandomState(2)
    if case == "on_levels":
        xp, expect = x[[0, 3, 5]], y[[0, 3, 5]]
    elif case == "last_level":
        xp, expect = x[-1:], y[-1:]
    elif case == "below":
        xp, expect = x[:1] - 1e-3 - rng.rand(2, *x.shape[1:]), None
    elif case == "above":
        xp, expect = x[-1:] + 1e-3 + rng.rand(2, *x.shape[1:]), None
    else:
        lo, hi = x[0], x[-1]
        xp, expect = lo + (hi - lo) * rng.rand(6, *x.shape[1:]), None
    got, want = _both(xp, x, y)
    _close(got, want, np.abs(y).max())
    if expect is not None:
        np.testing.assert_allclose(got, expect, rtol=0,
                                   atol=RTOL * np.abs(y).max())
    if case in ("below", "above"):
        assert np.isnan(got).all()


@pytest.mark.parametrize("fill", [np.nan, -999.0, 0.0])
def test_interpolate_columns_fill_value(fill):
    """Out-of-range targets get the fill value, in range ones do not."""
    x, y = _columns(3)
    xp = np.concatenate([x[:1] - 1.0, 0.5 * (x[:1] + x[1:2]), x[-1:] + 1.0])
    got, want = _both(xp, x, y, fill)
    _close(got, want, np.abs(y).max())
    for row in (0, 2):
        if np.isnan(fill):
            assert np.isnan(got[row]).all()
        else:
            assert (got[row] == fill).all()
    assert np.isfinite(got[1]).all()


def test_interpolate_columns_chunks(monkeypatch):
    """Columns taken a few at a time (5 of 42 a pass) give what one pass
    gives, to the rounding of the sum's order."""
    x, y = _columns(4, n_in=12, cols=(6, 7))
    xp = x[0] + (x[-1] - x[0]) * np.random.RandomState(5).rand(10, 6, 7)
    args = [torch.as_tensor(a) for a in (xp, x, y)]
    whole = tremap.interpolate_columns(*args).numpy()
    monkeypatch.setattr(tremap, "INTERP_CHUNK_ELEMENTS", 11 * 10 * 5)
    _close(tremap.interpolate_columns(*args).numpy(), whole,
           np.abs(y).max())


@pytest.mark.parametrize("axis", [0, 1, -1, -3])
def test_interpolate_1d_axes(axis):
    """interpolate_1d along other axes than the leading one."""
    x, y = _columns(6, n_in=7, cols=(3, 4, 5))  # [7, 3, 4, 5]
    rng = np.random.RandomState(7)
    xp = x[0] + (x[-1] - x[0]) * rng.rand(4, 3, 4, 5)
    xp[0] = x[-1]
    xp[1, 0] = x[0, 0] - 1.0
    xp, x, y = (np.moveaxis(a, 0, axis) for a in (xp, x, y))
    want = jint.interpolate_1d(xp, x, y, axis=axis)
    got = tint.interpolate_1d(xp, x, y, axis=axis, device="cpu")
    assert got.shape == want.shape and isinstance(got, np.ndarray)
    _close(got, want, np.abs(y).max())


@pytest.mark.parametrize("levels", ["grid", "three"])
def test_interpolate_to_pressure_levels(levels):
    """A [time, tile, z, y, x] field on its log-midpoint pressures onto
    the standard grid (some levels below the surface: NaN) and onto
    300/500/700 hPa."""
    rng = np.random.RandomState(8)
    delp = 1.0e5 / 8 * (0.9 + 0.2 * rng.rand(2, 6, 8, 4, 4))
    field = 250.0 + 30.0 * rng.rand(2, 6, 8, 4, 4)
    lev = (jint.PRESSURE_GRID if levels == "grid"
           else 100.0 * np.array([300.0, 500.0, 700.0]))
    want = jint.interpolate_to_pressure_levels(field, delp, levels=lev)
    got = tint.interpolate_to_pressure_levels(field, delp, levels=lev,
                                              device="cpu")
    assert got.shape == (2, 6, len(lev), 4, 4)
    _close(got, want, np.abs(field).max())
    np.testing.assert_array_equal(tint.PRESSURE_GRID, jint.PRESSURE_GRID)


def test_interpolate_1d_on_tensors_stays_on_their_device():
    """Tensors interpolate on their own device (here the CPU) with no
    device given; host arrays with no device need the card."""
    x, y = _columns(9)
    xp = x[[1, 2]]
    got = tint.interpolate_1d(*(torch.as_tensor(a) for a in (xp, x, y)),
                              axis=0)
    np.testing.assert_allclose(got, y[[1, 2]], rtol=0,
                               atol=RTOL * np.abs(y).max())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="interpolate_1d"):
            tint.interpolate_1d(xp, x, y, axis=0)


@pytest.mark.parametrize("keys", [
    ("lon", "lat"), ("LON", "Lat"), ("longitude", "LATITUDE"),
    ("lon", "lat", "pressure"), ("pressure",), ("LON", "pressure"),
])
def test_interpolate_unstructured(keys):
    """Nearest neighbours on the unit sphere for lon/lat keys in any
    case, euclidean for another coordinate (and for an unpaired lon)."""
    rng = np.random.RandomState(10)
    ns, nt = 40, 15
    src = {"lon": rng.uniform(0, 360, ns), "lat": rng.uniform(-90, 90, ns),
           "pressure": rng.uniform(1e4, 1e5, ns)}
    tgt = {"lon": rng.uniform(0, 360, nt), "lat": rng.uniform(-90, 90, nt),
           "pressure": rng.uniform(1e4, 1e5, nt)}
    base = {"lon": "lon", "longitude": "lon", "lat": "lat",
            "latitude": "lat", "pressure": "pressure"}
    coords = {k: (src[base[k.lower()]], tgt[base[k.lower()]]) for k in keys}
    data = {"a": rng.randn(3, ns), "b": rng.randn(ns)}
    want = jint.interpolate_unstructured(data, coords)
    got = tint.interpolate_unstructured(data, coords)
    assert sorted(got) == ["a", "b"]
    for k in data:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].shape[-1] == nt
