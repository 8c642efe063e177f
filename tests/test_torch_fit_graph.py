"""The port's graph family (message passing, ``mpg``, and the graph-UNet,
``unet``) against the JAX package's: the forward from the same
parameters, one Adam step and a short run from the JAX package's initial
parameters (carried across by convert.py), the predictions of the
trained models, and dumps loading across.

Tolerances.  The forward in float64: FWD_RTOL 1e-12 of the output.
Training runs in float32 in both packages, one cube a step: one step
agrees to STEP_RTOL, a short run to RUN_RTOL of each array's magnitude,
the predictions to PRED_RTOL of each output's (measured values in each
test's docstring)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu import fit as jfit
from fv3net_tpu.fit.graph import _build as jbuild
from fv3net_tpu_torch import fit as tfit
from fv3net_tpu_torch.convert import module_from_flax
from fv3net_tpu_torch.fit import graph as tgraph
from fv3net_tpu_torch.util.quantity import Quantity as TQuantity
from test_fit_families import N, NZ, _cube_batch
from torch_parity import (
    assert_close_scaled,
    assert_params_close,
    flax_numpy,
    use_jax_init,
)

torch.set_num_threads(1)

FWD_RTOL = 1e-12
STEP_RTOL = 1e-6
RUN_RTOL = 1e-5
PRED_RTOL = 1e-5
ARCHS = ["mpg", "unet"]


def _as_port(batch):
    return {k: TQuantity(np.asarray(q.data), q.dims, q.units)
            for k, q in batch.items()}


def _hp(pkg, arch, epochs):
    f = jfit if pkg == "jax" else tfit
    return f.GraphHyperparameters(architecture=arch, width=6, depth=2,
                                  epochs=epochs, learning_rate=3e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_graph_forward_matches_flax(arch):
    """The network on a random [6, 8, 8, 3] cube with random float64
    parameters: the UNet pools 8 -> 4 -> 2 and unpools back.  The layer
    names of the port's module are flax's.  Measured: <= 6.0e-16 of the
    output."""
    rng = np.random.RandomState(1)
    x = rng.randn(6, N, N, 3)
    hp = _hp("jax", arch, 1)
    jm = jbuild(hp, 2)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.5 * rng.randn(*a.shape)), params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = tgraph._build(_hp("torch", arch, 1), 3, 2).double()
    flat = flax_numpy(params)
    assert sorted(tm.flax_layers()) == sorted(flat)
    module_from_flax(tm, flat)
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
    assert_close_scaled(got, want, FWD_RTOL, arch)


def _train_both(monkeypatch, arch, epochs, ncubes):
    batches = [_cube_batch(s) for s in range(ncubes)]
    hp = _hp("jax", arch, epochs)
    use_jax_init(monkeypatch, jbuild(hp, NZ), (6, N, N, NZ), hp.seed)
    jm = jfit.train_graph_model(hp, batches, input_variables=["a_in"],
                                output_variables=["b_out"])
    tm = tfit.train_graph_model(_hp("torch", arch, epochs),
                                [_as_port(b) for b in batches],
                                input_variables=["a_in"],
                                output_variables=["b_out"], device="cpu")
    return jm, tm


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("epochs,ncubes,rtol", [
    (1, 1, STEP_RTOL), (3, 2, RUN_RTOL)])
def test_graph_training_matches_jax(monkeypatch, arch, epochs, ncubes, rtol):
    """One Adam step and six (three epochs of two cubes, in sample
    order): the parameters and the predictions on another cube.
    Measured: parameters <= 2.4e-7 (one step) and 2.7e-7 (six) of each
    array, predictions <= 3.3e-7 of the output."""
    jm, tm = _train_both(monkeypatch, arch, epochs, ncubes)
    assert_params_close(jm.params, tm.module, rtol, f"{arch} {epochs}")
    x = _cube_batch(7)
    want, got = jm.predict(x), tm.predict(_as_port(x))
    assert got["b_out"].dims == want["b_out"].dims
    assert isinstance(got["b_out"].data, np.ndarray)
    assert_close_scaled(got["b_out"].values, want["b_out"].values,
                        PRED_RTOL, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_graph_dumps_cross_both_ways(tmp_path, monkeypatch, arch):
    """A JAX dump loads in the port (``fit.load``), predicts the same and
    writes the same params.npy back bit for bit; a port dump loads in the
    JAX package and predicts the same.  Measured: <= 2.7e-7."""
    jm, tm = _train_both(monkeypatch, arch, 2, 1)
    x = _cube_batch(5)
    jfit.dump(jm, str(tmp_path / "jax"))
    loaded = tfit.load(str(tmp_path / "jax"), "cpu")
    assert isinstance(loaded, tfit.GraphModel)
    assert_close_scaled(loaded.predict(_as_port(x))["b_out"].values,
                        jm.predict(x)["b_out"].values, PRED_RTOL, "jax->port")
    tfit.dump(loaded, str(tmp_path / "again"))
    np.testing.assert_array_equal(np.load(tmp_path / "again" / "params.npy"),
                                  np.load(tmp_path / "jax" / "params.npy"))
    tfit.dump(tm, str(tmp_path / "port"))
    back = jfit.load(str(tmp_path / "port"))
    assert_close_scaled(back.predict(x)["b_out"].values,
                        tm.predict(_as_port(x))["b_out"].values, PRED_RTOL,
                        "port->jax")
