"""fv3net_tpu_torch ops.cuda_column (plain path of K4) against the JAX
package's Pallas column kernel in interpret mode and its jnp chain
(dycore/hydro.py:528-539 plus layer_mean_pressure), float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu.constants import KAPPA, REFERENCE_SURFACE_PRESSURE as P00
from fv3net_tpu.dycore.riemann import layer_mean_pressure
from fv3net_tpu.ops.pallas_column import column_pressures_pallas
from fv3net_tpu_torch.ops import cuda_column

torch.set_num_threads(1)

PTOP = 300.0


def _dp(shape, seed=0):
    rng = np.random.RandomState(seed)
    return 900.0 + 200.0 * rng.rand(*shape)


def _jnp_chain(dp):
    pe = PTOP + jnp.concatenate(
        [jnp.zeros_like(dp[:, :1]), jnp.cumsum(dp, axis=1)], axis=1
    )
    pik = (pe / P00) ** KAPPA
    pi = (pik[:, 1:] * pe[:, 1:] - pik[:, :-1] * pe[:, :-1]) / (
        (1.0 + KAPPA) * dp
    )
    return pe, pi, layer_mean_pressure(dp, pe)


# f64: identical prefix sums; pi_lay differences large pik*pe products,
# which amplifies roundoff ~100x (1e-13 leaves margin)
@pytest.mark.parametrize("reference", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("shape", [(6, 13, 8, 16), (6, 7, 18, 18)])
def test_column_pressures_plain_matches(reference, shape):
    dp = _dp(shape, seed=shape[1])
    if reference == "jnp":
        want = _jnp_chain(jnp.asarray(dp))
    else:
        want = column_pressures_pallas(jnp.asarray(dp), PTOP, interpret=True)
    got = cuda_column.column_pressures(torch.as_tensor(dp), PTOP)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13)


def test_garbage_columns_do_not_raise():
    """Halo-corner columns of a padded field may hold garbage (negative
    or NaN thickness): the chain must pass them through, not raise."""
    dp = torch.as_tensor(_dp((6, 5, 6, 6)))
    dp[:, :, 0, 0] = -1e6
    dp[:, :, 0, 1] = float("nan")
    pe, pi, pm = cuda_column.column_pressures(dp, PTOP)
    assert bool(torch.isfinite(pe[:, :, 2:, 2:]).all())
    assert bool(torch.isnan(pi[:, :, 0, 1]).all())
