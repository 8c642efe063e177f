"""Shared inputs for the parity tests of fv3net_tpu_torch against the JAX
package (tests/test_torch_*.py): both packages get the same numpy arrays,
made from a seed, and step in float64 on the CPU."""

import dataclasses

import numpy as np


def jax_metrics_arrays(m):
    """Every array field of a JAX SWMetrics (plus n, halo, divdamp_scale)
    as numpy, the input of fv3net_tpu_torch.convert.metrics_from_numpy."""
    out = {}
    for f in dataclasses.fields(m):
        val = getattr(m, f.name)
        if val is None or isinstance(val, bool):
            continue
        out[f.name] = val if isinstance(val, (int, float)) else np.asarray(val)
    return out


def benchmark_like_state(n, nz, seed=0):
    """Rest state on the hybrid coordinate with seeded perturbations of
    pt, random winds and a positive tracer (numpy float64 arrays)."""
    from fv3net_tpu.constants import KAPPA, REFERENCE_SURFACE_PRESSURE
    from fv3net_tpu.dycore.hydro import hybrid_coefficients

    ak, bk = (np.asarray(c) for c in hybrid_coefficients(nz, 300.0))
    pe = ak[:, None, None] + bk[:, None, None] * 1e5
    delp = np.broadcast_to(pe[1:] - pe[:-1], (6, nz, n, n)).copy()
    pik = (pe / REFERENCE_SURFACE_PRESSURE) ** KAPPA
    theta = 285.0 / (0.5 * (pik[1:] + pik[:-1]))
    pt = np.broadcast_to(theta, (6, nz, n, n)).copy()
    rng = np.random.RandomState(seed)
    pt = pt + rng.standard_normal(pt.shape)
    u = rng.standard_normal((6, nz, n + 1, n))
    v = rng.standard_normal((6, nz, n, n + 1))
    q = np.abs(rng.standard_normal((1, 6, nz, n, n))) * 1e-3
    return delp, pt, u, v, q


def assert_close_scaled(got, want, rtol, name=""):
    """max |got - want| <= rtol * max |want| (fields whose magnitude
    varies by orders across the array, e.g. winds near zero)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max()
    assert np.isfinite(got).all(), f"{name}: non-finite values"
    assert err <= rtol * scale, (
        f"{name}: max abs err {err:.3e} > {rtol} * {scale:.3e}"
    )
