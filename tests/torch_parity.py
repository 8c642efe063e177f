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


def use_jax_init(monkeypatch, jmodule, shape, seed=0):
    """Make the port's next trainings start from the JAX package's initial
    parameters: flax's ``jmodule.init(PRNGKey(seed), zeros(shape))``, as
    the JAX package's training functions draw them, replaces
    ``fv3net_tpu_torch.fit._shared.init_params`` (JAX's threefry draws
    cannot be matched).  Returns the flax params as numpy."""
    import jax
    import jax.numpy as jnp

    from fv3net_tpu_torch import convert
    from fv3net_tpu_torch.fit import _shared

    params = jmodule.init(jax.random.PRNGKey(seed), jnp.zeros(shape))
    params = flax_numpy(params["params"])
    monkeypatch.setattr(
        _shared, "init_params",
        lambda module, seed: convert.module_from_flax(module, params),
    )
    return params


def flax_numpy(params):
    """A flax params dict as {layer: {"bias", "kernel"}} numpy arrays, a
    nested module's layers named by their path ("_GRUCell_0/Dense_1")."""
    from fv3net_tpu_torch.convert import flax_params_flatten

    return flax_params_flatten(params)


def use_jax_inits(monkeypatch, params_list):
    """Make the port's next ``init_params`` calls load the flax params of
    `params_list` in turn (a family that initialises several modules,
    each from its own key)."""
    from fv3net_tpu_torch import convert
    from fv3net_tpu_torch.fit import _shared

    queue = [flax_numpy(p) for p in params_list]
    monkeypatch.setattr(
        _shared, "init_params",
        lambda module, seed: convert.module_from_flax(module, queue.pop(0)),
    )


def assert_params_close(jparams, tmodule, rtol, name=""):
    """Each layer's bias and kernel of one of the port's models against a
    flax params dict: max|diff| <= rtol * max|flax value| per array."""
    from fv3net_tpu_torch.convert import module_flax_params

    got = module_flax_params(tmodule)
    want = flax_numpy(jparams)
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for layer in want:
        for k in ("bias", "kernel"):
            assert got[layer][k].shape == want[layer][k].shape
            w = want[layer][k]
            if not np.abs(w).max() > 0.0:  # zero biases of one step
                w = want[layer]["kernel"]
            err = np.abs(got[layer][k] - want[layer][k]).max()
            assert err <= rtol * np.abs(w).max(), (
                f"{name} {layer}.{k}: max abs err {err:.3e} > {rtol} * "
                f"{np.abs(w).max():.3e}"
            )
