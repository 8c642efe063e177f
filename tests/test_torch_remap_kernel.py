"""K5's plain version (fv3net_tpu_torch ops.remap.remap_levels_plain, the
conservative remap on the native [F, nz, Y, X] layout) against the JAX
package's Pallas kernel ppm_remap_pallas, run in interpret mode on the
CPU as tests/test_pallas_kernels.py:214-245 runs it, with that test's
inputs and tolerance (2e-5), plus the dispatch of remap_levels on CPU
tensors.

Both run in float64 on the f32-rounded inputs: in float32 the comparison
would measure rounding order, not the algorithm -- with these inputs the
Pallas kernel's cumulative integration is 1.7e-2 from its own float64
answer in thin target layers (the port integrates per layer overlap,
4e-6 from it).  Limiter branches that sit on an exact tie (see
tests/test_torch_remap.py) may go either way in two correct
implementations: a column may differ only where the oracle flags a tie
in its profile."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu.ops.pallas_remap import ppm_remap_pallas
from fv3net_tpu_torch.ops import remap as tremap
from fv3net_tpu_torch.ops.cuda_remap import ppm_remap_cuda
from reference_mappm import cs_profile_ref
from test_pallas_kernels import _remap_args

torch.set_num_threads(1)


def _inputs(stag=(0, 0), seed=0):
    """The JAX kernel test's q, pe1, pe2 [6, 13, Y, X], as float64."""
    return [np.asarray(a, np.float64)
            for a in _remap_args(stag=stag, seed=seed)]


def _tie_columns(q, pe1, iv, kord):
    """[F, Y, X]: the oracle's profile of the column has a branch tie."""
    F, _, Y, X = q.shape
    dp = np.diff(pe1, axis=1)
    tie = np.zeros((F, Y, X), bool)
    for f in range(F):
        for y in range(Y):
            for x in range(X):
                tie[f, y, x] = cs_profile_ref(
                    q[f, :, y, x], dp[f, :, y, x], iv, kord,
                    return_ties=True,
                )[3].any()
    return tie


@pytest.mark.parametrize("stag", [(0, 0), (1, 0), (0, 1)])
@pytest.mark.parametrize("kord", [9, 10, 17])
@pytest.mark.parametrize("iv", [1, 0, -1])
def test_remap_levels_plain_matches_pallas(iv, kord, stag):
    q, pe1, pe2 = _inputs(stag)
    want = np.asarray(ppm_remap_pallas(
        jnp.asarray(q), jnp.asarray(pe1), jnp.asarray(pe2), iv=iv,
        kord=kord, interpret=True,
    ))
    got = tremap.remap_levels_plain(
        *(torch.as_tensor(a) for a in (q, pe1, pe2)), iv, kord
    ).numpy()
    bad = (np.abs(got - want) > 2e-5 + 2e-5 * np.abs(want)).any(axis=1)
    if bad.any():
        tie = _tie_columns(q, pe1, iv, kord)
        assert not (bad & ~tie).any(), (
            f"{int((bad & ~tie).sum())} tie-free columns differ"
        )
        assert bad.mean() < 0.1, f"{bad.mean():.2f} of the columns differ"


@pytest.mark.parametrize("kord", [9, 10, 17])
def test_remap_levels_plain_conservative(kord):
    """Column mass (test_pallas_kernels.py:233-245), here in float32."""
    q, pe1, pe2 = (torch.as_tensor(a).float() for a in _inputs(seed=4))
    out = tremap.remap_levels_plain(q, pe1, pe2, 1, kord)
    m1 = (q * (pe1[:, 1:] - pe1[:, :-1])).double().sum(1)
    m2 = (out * (pe2[:, 1:] - pe2[:, :-1])).double().sum(1)
    np.testing.assert_allclose(m2.numpy(), m1.numpy(), rtol=2e-4)


def test_remap_levels_tracer_stack_equals_per_field():
    """A stack of fields on one pressure grid ([ntr * 6, ...] against
    [6, ...] pressures) remaps as each field alone."""
    q, pe1, pe2 = (torch.as_tensor(a) for a in _inputs(seed=2))
    stack = torch.cat([q, 0.5 * q.flip(1), q * q])
    got = tremap.remap_levels_plain(stack, pe1, pe2, 0, 9)
    for i in range(3):
        want = tremap.remap_levels_plain(stack[6 * i : 6 * i + 6], pe1, pe2,
                                         0, 9)
        assert torch.equal(got[6 * i : 6 * i + 6], want)


@pytest.mark.parametrize("iv,kord", [(1, 9), (0, 10), (-1, 17), (1, 7),
                                     (-2, 9)])
def test_remap_levels_cpu_is_plain_and_counts_nothing(iv, kord):
    q, pe1, pe2 = (torch.as_tensor(a) for a in _inputs(seed=3))
    ppm_remap_cuda.launches = 0
    got = tremap.remap_levels(q, pe1, pe2, iv, kord)
    want = tremap.remap_levels_plain(q, pe1, pe2, iv, kord)
    assert torch.equal(got, want)
    assert ppm_remap_cuda.launches == 0


def test_ppm_remap_cuda_refuses():
    q, pe1, pe2 = (torch.as_tensor(a).float() for a in _inputs(seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        ppm_remap_cuda(q, pe1, pe2, 1, 9)
    with pytest.raises(ValueError, match="does not cover"):
        ppm_remap_cuda(q, pe1, pe2, 1, 12)
