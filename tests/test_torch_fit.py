"""The port's dense ML predictor against the JAX package's: a model
trained and dumped by the JAX package (fit.train_dense_model, fit.dump)
and loaded by both.  The MLP runs in float32 in both packages; their
matmuls sum in other orders, so outputs agree to float32 roundoff of the
normalised outputs (RTOL), the rest of the chain in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from fv3net_tpu import fit as jfit
from fv3net_tpu.data import SyntheticWaves
from fv3net_tpu.fit.dense import _MLP as JMLP
from fv3net_tpu.util.quantity import Quantity as JQuantity
from fv3net_tpu_torch import fit as tfit
from fv3net_tpu_torch.convert import (
    flax_params_to_flat,
    module_flax_params,
    module_from_flat,
)
from fv3net_tpu_torch.fit.dense import _MLP as TMLP
from fv3net_tpu_torch.util.quantity import Quantity as TQuantity
from torch_parity import assert_close_scaled

torch.set_num_threads(1)

N, NZ = 6, 8
INPUTS = ["air_temperature", "specific_humidity"]
OUTPUTS = ["dQ1", "dQ2"]
RTOL = 1e-5  # float32 MLP: ~1e-7 of the normalised outputs


def _train_and_dump(path, depth, width):
    batches = SyntheticWaves(
        INPUTS + OUTPUTS, n=N, nz=NZ, nbatch=1, seed=0
    ).batches()
    model = jfit.train_dense_model(
        jfit.DenseHyperparameters(depth=depth, width=width, epochs=1),
        batches, input_variables=INPUTS, output_variables=OUTPUTS,
    )
    jfit.dump(model, str(path))
    return jfit.load(str(path))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = tmp_path_factory.mktemp("dense")
    return _train_and_dump(path, 2, 16), tfit.load(str(path), "cpu")


def _arrays(seed):
    rng = np.random.RandomState(seed)
    return {
        "air_temperature": 250.0 + 30.0 * rng.rand(6, NZ, N, N),
        "specific_humidity": 1e-2 * rng.rand(6, NZ, N, N),
    }


def test_load_reads_the_jax_dump(models):
    jm, tm = models
    assert isinstance(tm, tfit.DenseModel)
    assert tm.input_variables == jm.input_variables
    assert tm.output_variables == jm.output_variables
    assert tm.module.widths == tuple(jm.module.widths)
    np.testing.assert_array_equal(tm.scaler_in.mean, jm.scaler_in.mean)
    np.testing.assert_array_equal(tm.scaler_out.std, jm.scaler_out.std)
    assert tm.packer_out._feature_counts == jm.packer_out._feature_counts
    for name, p in jm.params.items():
        i = int(name.split("_")[1])
        np.testing.assert_array_equal(
            tm.params[f"layers.{i}.weight"].numpy(), np.asarray(p["kernel"]).T
        )
        np.testing.assert_array_equal(
            tm.params[f"layers.{i}.bias"].numpy(), np.asarray(p["bias"])
        )


def test_pure_fn_matches_jax(models):
    jm, tm = models
    arrs = _arrays(1)
    want = jm.pure_fn(jm.params, {k: jnp.asarray(v) for k, v in arrs.items()})
    got = tm.pure_fn(
        tm.params_on("cpu"), {k: torch.as_tensor(v) for k, v in arrs.items()}
    )
    assert set(got) == set(want)
    for k in OUTPUTS:
        assert got[k].dtype == torch.float32  # denormalised in float32
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert_close_scaled(got[k].numpy(), np.asarray(want[k]), RTOL, k)


def test_predict_matches_jax_on_host_arrays(models):
    """The numpy path (packers + host scalers) of predict."""
    jm, tm = models
    arrs = _arrays(2)
    dims = ("tile", "z", "y", "x")
    want = jm.predict({k: JQuantity(v, dims) for k, v in arrs.items()})
    got = tm.predict({k: TQuantity(v, dims) for k, v in arrs.items()})
    for k in OUTPUTS:
        assert got[k].dims == want[k].dims
        assert isinstance(got[k].data, np.ndarray)
        assert_close_scaled(got[k].values, want[k].values, RTOL, k)


def test_predict_on_tensors_is_pure_fn(models):
    """A tensor state runs pure_fn on its device and stays a tensor."""
    _, tm = models
    arrs = {k: torch.as_tensor(v) for k, v in _arrays(3).items()}
    dims = ("tile", "z", "y", "x")
    got = tm.predict({k: TQuantity(v, dims) for k, v in arrs.items()})
    want = tm.pure_fn(tm.params_on("cpu"), arrs)
    for k in OUTPUTS:
        assert torch.equal(got[k].data, want[k])


def test_flat_params_unravel_in_flax_order():
    """params.npy is ravel_pytree of the flax params: layer names sorted
    as strings (Dense_10 before Dense_2), bias before kernel.  Depth 11,
    width 2: twelve layers, so the Dense_10/Dense_11 case occurs."""
    widths, n_in, n_out = (2,) * 11, 3, 4
    module = JMLP(widths, n_out)
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, n_in)))["params"]
    # distinct values everywhere, so any misplaced block shows
    flat, unravel = ravel_pytree(params)
    params = unravel(jnp.arange(flat.size, dtype=flat.dtype))
    flat, _ = ravel_pytree(params)
    module = TMLP(n_in, widths, n_out)
    module_from_flat(module, np.asarray(flat))
    got = module_flax_params(module)
    assert sorted(got) == sorted(params)
    for name, p in params.items():
        for k in ("bias", "kernel"):
            np.testing.assert_array_equal(got[name][k], np.asarray(p[k]))
    np.testing.assert_array_equal(
        module.layers[10].weight.detach().numpy(),
        np.asarray(params["Dense_10"]["kernel"]).T,
    )
    np.testing.assert_array_equal(flax_params_to_flat(got), np.asarray(flat))


def test_deep_model_loads_and_matches_jax(tmp_path):
    """A JAX-dumped model of depth 11 and width 2 through the port."""
    jm = _train_and_dump(tmp_path, 11, 2)
    tm = tfit.load(str(tmp_path), "cpu")
    assert len(tm.module.layers) == 12
    arrs = _arrays(4)
    want = jm.pure_fn(jm.params, {k: jnp.asarray(v) for k, v in arrs.items()})
    got = tm.pure_fn(
        tm.params_on("cpu"), {k: torch.as_tensor(v) for k, v in arrs.items()}
    )
    for k in OUTPUTS:
        assert_close_scaled(got[k].numpy(), np.asarray(want[k]), RTOL, k)


def test_seeded_artifact_is_a_jax_dump(tmp_path):
    """runtime.coupled_bench trains its dense model (seeded, as bench.py
    rung 3 trains its MLP) and dumps it in the JAX package's format: the
    JAX package loads it, both packages predict the same tendencies, of
    physical size, and the port's writer is the inverse of its reader.
    On these inputs the trained artifact's max|dQ1| is 1.13e-5 K/s and
    its max|dQ2| 1.29e-8 /s (the CPU, float32)."""
    from fv3net_tpu_torch.runtime.coupled_bench import train_dense_artifact

    train_dense_artifact(str(tmp_path), NZ, "cpu", depth=2, width=8)
    jm, tm = jfit.load(str(tmp_path)), tfit.load(str(tmp_path), "cpu")
    module = TMLP(2 * NZ, (8, 8), 2 * NZ)
    module_from_flat(module, np.load(tmp_path / "params.npy"))
    np.testing.assert_array_equal(
        flax_params_to_flat(module_flax_params(module)),
        np.load(tmp_path / "params.npy"),
    )
    arrs = _arrays(6)
    want = jm.pure_fn(jm.params, {k: jnp.asarray(v) for k, v in arrs.items()})
    got = tm.pure_fn(
        tm.params_on("cpu"), {k: torch.as_tensor(v) for k, v in arrs.items()}
    )
    for k, size in (("dQ1", 1e-5), ("dQ2", 1e-8)):
        assert_close_scaled(got[k].numpy(), np.asarray(want[k]), RTOL, k)
        assert 0.1 * size < float(got[k].abs().max()) < 100.0 * size


def test_unported_model_type_raises(tmp_path):
    (tmp_path / "name").write_text("no_such_model")
    with pytest.raises(NotImplementedError, match="no_such_model"):
        tfit.load(str(tmp_path), "cpu")


def test_array_packer_round_trip():
    """to_array / to_state keep the kind of array they are given."""
    arrs = _arrays(5)
    dims = ("tile", "z", "y", "x")
    for wrap in (np.asarray, torch.as_tensor):
        state = {k: TQuantity(wrap(v), dims) for k, v in arrs.items()}
        packer = tfit.ArrayPacker(INPUTS)
        X = packer.to_array(state)
        assert tuple(X.shape) == (6 * N * N, 2 * NZ)
        back = packer.to_state(X, state)
        for k in INPUTS:
            assert type(back[k].data) is type(state[k].data)
            np.testing.assert_array_equal(back[k].values, arrs[k])
