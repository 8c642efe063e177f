"""fv3net_tpu_torch dycore.sw.scalar_filter (plain path of K3) against
the JAX package's jnp scalar_filter and its Pallas del-4 kernel in
interpret mode, float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu.dycore import sw as jsw
from fv3net_tpu.grid import CubedSphereGrid as JGrid
from fv3net_tpu.grid.halo import halo_exchange as jhalo_exchange
from fv3net_tpu.ops.pallas_filter import del4_filter_pallas
from fv3net_tpu_torch.convert import metrics_from_numpy
from fv3net_tpu_torch.dycore import sw as tsw
from torch_parity import jax_metrics_arrays

torch.set_num_threads(1)

n, H = 12, 3


@pytest.fixture(scope="module")
def metrics():
    mj = jsw.SWMetrics.make(JGrid.make(n, halo=H), jnp.float64)
    return mj, metrics_from_numpy(jax_metrics_arrays(mj), "cpu")


@pytest.mark.parametrize("shape", [(6, 4, n, n), (6, n, n)])
def test_scalar_filter_matches_jnp(metrics, shape):
    mj, mt = metrics
    q = np.random.RandomState(len(shape)).randn(*shape)
    want = jsw.scalar_filter(jnp.asarray(q), mj, jsw.FILTER_COEF)
    got = tsw.scalar_filter(torch.as_tensor(q), mt, tsw.FILTER_COEF)
    # same flux-form operator, same order of operations: f64 roundoff
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13,
                               atol=1e-13)


def test_scalar_filter_matches_pallas_interpret(metrics):
    """The TPU kernel computes the halo band of L(q) locally instead of
    re-exchanging it; the port's plain form (the exchanged L_local) must
    agree with it (the check the JAX package made only in interpret
    mode, now against the independent plain form)."""
    mj, mt = metrics
    q = np.random.RandomState(7).randn(6, 3, n, n)
    qj = jnp.asarray(q)
    want = del4_filter_pallas(
        jhalo_exchange(qj, H, "x"), jhalo_exchange(qj, H, "y"),
        mj.area_px, mj.area_py, 0.02, H, interpret=True,
    )
    got = tsw.scalar_filter(torch.as_tensor(q), mt, 0.02)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-13)


def test_scalar_filter_conserves_and_zero_coef(metrics):
    _, mt = metrics
    q = torch.as_tensor(np.random.RandomState(8).randn(6, 2, n, n))
    out = tsw.scalar_filter(q, mt, 0.02)
    area = 1.0 / mt.rarea[:, None]
    assert abs(float((out * area).sum() - (q * area).sum())) < 1e-6 * float(
        (q.abs() * area).sum()
    )
    assert tsw.scalar_filter(q, mt, 0.0) is q
