"""fv3net_tpu_torch dycore.sw: the metrics, the wind dampers and the
C-grid wind chain against the JAX package, float64 on the CPU at C12."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu.dycore import sw as jsw
from fv3net_tpu.grid import CubedSphereGrid as JGrid
from fv3net_tpu.grid.halo import halo_exchange_dgrid as jexchange_dgrid
from fv3net_tpu_torch.convert import metrics_from_numpy
from fv3net_tpu_torch.dycore import sw as tsw
from fv3net_tpu_torch.grid import CubedSphereGrid as TGrid
from fv3net_tpu_torch.grid.halo import halo_exchange_dgrid
from torch_parity import jax_metrics_arrays

torch.set_num_threads(1)

n, H, NZ = 12, 3, 3


@pytest.fixture(scope="module")
def metrics():
    mj = jsw.SWMetrics.make(JGrid.make(n, halo=H), jnp.float64)
    mt = tsw.SWMetrics.make(TGrid.make(n, halo=H), torch.float64,
                            device="cpu")
    return mj, mt


def test_swmetrics_make_matches_jax(metrics):
    """Same numpy geometry and exact gathers: every tensor field equal;
    the power-iteration normalisation to 1e-10 relative (30 vjp steps
    whose sums are ordered differently)."""
    mj, mt = metrics
    for f in dataclasses.fields(mt):
        got = getattr(mt, f.name)
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(getattr(mj, f.name)),
                err_msg=f.name,
            )
    assert mt.n == mj.n and mt.halo == mj.halo
    assert abs(mt.divdamp_scale / mj.divdamp_scale - 1.0) < 1e-10


def test_metrics_from_numpy_round_trip(metrics):
    mj, _ = metrics
    arrays = jax_metrics_arrays(mj)
    m2 = metrics_from_numpy(arrays, "cpu")
    assert (m2.n, m2.halo) == (mj.n, mj.halo)
    assert m2.divdamp_scale == mj.divdamp_scale
    for f in dataclasses.fields(m2):
        got = getattr(m2, f.name)
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.numpy(), arrays[f.name],
                                          err_msg=f.name)
    m3 = metrics_from_numpy(arrays, "cpu", dtype=torch.float32)
    assert m3.area_px.dtype == torch.float32


def _winds(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(6, NZ, n + 1, n), rng.randn(6, NZ, n, n + 1)


# f64 roundoff: the vjp transposes sum each adjoint in another order than
# JAX's gather-form transpose (~1e-15 relative)
DAMPERS = {
    "div_damp": (jsw.div_damp, tsw.div_damp, 0.12),
    "vort_damp": (jsw.vort_damp, tsw.vort_damp, jsw.VORT_DAMP_COEF),
    "corner_div_damp": (
        jsw.corner_div_damp, tsw.corner_div_damp, jsw.CORNER_DAMP_COEF
    ),
}


@pytest.mark.parametrize("name", sorted(DAMPERS))
def test_dampers_match_jax(metrics, name):
    mj, mt = metrics
    fj, ft, c = DAMPERS[name]
    u, v = _winds(len(name))
    want = fj(jnp.asarray(u), jnp.asarray(v), mj, c)
    got = ft(torch.as_tensor(u), torch.as_tensor(v), mt, c)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-12 * np.abs(w).max()


def test_padded_cgrid_winds_match_jax(metrics):
    mj, mt = metrics
    u, v = _winds(3)
    want = jsw.padded_cgrid_winds(jnp.asarray(u), jnp.asarray(v), mj)
    got = tsw.padded_cgrid_winds(torch.as_tensor(u), torch.as_tensor(v), mt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13,
                                   atol=1e-13)


def test_c_half_winds_common_matches_jax(metrics):
    mj, mt = metrics
    u, v = _winds(4)
    uj, vj = jnp.asarray(u), jnp.asarray(v)
    up_j, vp_j = jexchange_dgrid(uj, vj, H)
    cw_j = jsw.padded_cgrid_winds(uj, vj, mj, up_j, vp_j)
    want = jsw._c_half_winds_common(*cw_j, up_j, vp_j, mj)[1:]
    ut, vt = torch.as_tensor(u), torch.as_tensor(v)
    up_t, vp_t = halo_exchange_dgrid(ut, vt, H)
    cw_t = tsw.padded_cgrid_winds(ut, vt, mt, up_t, vp_t)
    got = tsw._c_half_winds_common(*cw_t, up_t, vp_t, mt)[1:]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-15)
    # and the finishing crop/canonicalise/exchange with a given increment
    duc = 0.1 * cw_t[0]
    dvc = 0.1 * cw_t[1]
    want = jsw._finish_c_half(cw_j[0], cw_j[1], 0.1 * cw_j[0],
                              0.1 * cw_j[1], mj)
    got = tsw._finish_c_half(cw_t[0], cw_t[1], duc, dvc, mt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13,
                                   atol=1e-13)


def test_masked_vertex_set_matches_and_checks_range():
    arr = np.random.RandomState(5).randn(6, 2, 5, 5)
    val = np.full((6, 2), 7.0)
    want = jsw._masked_vertex_set(jnp.asarray(arr), (3, 4),
                                  jnp.asarray(val), None)
    got = tsw._masked_vertex_set(torch.as_tensor(arr), (3, 4),
                                 torch.as_tensor(val))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got is not arr
    # the JAX form silently does nothing out of range; the port raises
    for idx in ((-1, 0), (0, -1), (5, 0), (0, 5)):
        with pytest.raises(IndexError):
            tsw._masked_vertex_set(torch.as_tensor(arr), idx,
                                   torch.as_tensor(val))
