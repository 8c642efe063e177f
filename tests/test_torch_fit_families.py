"""The port's precipitative and convolutional families against the JAX
package's: one Adam step and a short run from the same initial
parameters (the JAX package's, carried across by convert.py), the
predictions of the trained models, and the convolutional family's
cube-topology halo append (``append_halos``).

Tolerances.  Both packages train in float32; their matmuls and
convolutions sum in other orders.  One step agrees to 2.3e-7 of each
array's magnitude (measured, both families): STEP_RTOL 1e-6; a short
run (18 precipitative steps, 6 convolutional ones) to 3.4e-7 / 2.4e-7
(measured): RUN_RTOL 1e-5 (Adam's normalised updates keep the roundoff
of the gradients at their own relative size).
Predictions: PRED_RTOL 1e-5 of each output's magnitude.  The halo append
is a gather: bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu import fit as jfit
from fv3net_tpu.fit.convolutional import _CNN as JCNN
from fv3net_tpu.fit.precipitative import _Trunk as JTrunk
from fv3net_tpu.util.quantity import Quantity as JQuantity
from fv3net_tpu_torch import fit as tfit
from fv3net_tpu_torch.util.quantity import Quantity as TQuantity
from test_fit_families import N, NZ, _cube_batch, _precip_batch
from torch_parity import assert_close_scaled, assert_params_close, use_jax_init

torch.set_num_threads(1)

STEP_RTOL = 1e-6
RUN_RTOL = 1e-5
PRED_RTOL = 1e-5
PRECIP_IN = ["air_temperature", "specific_humidity",
             "pressure_thickness_of_atmospheric_layer"]
PRECIP_OUT = ["dQ1", "dQ2", "total_precipitation_rate"]


def _as_port(batch):
    return {k: TQuantity(np.asarray(q.data), q.dims, q.units)
            for k, q in batch.items()}


def _predict_both(jm, tm, x):
    want = jm.predict(x)
    got = tm.predict(_as_port(x))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dims == want[k].dims, k
        assert isinstance(got[k].data, np.ndarray)
        assert_close_scaled(got[k].values, want[k].values, PRED_RTOL, k)


@pytest.mark.parametrize("epochs,batch_size,rtol", [
    (1, 2 * 6 * N * N, STEP_RTOL), (3, 128, RUN_RTOL)])
def test_precipitative_training_matches_jax(monkeypatch, epochs,
                                            batch_size, rtol):
    batches = [_precip_batch(s) for s in range(2)]
    hp = jfit.PrecipitativeHyperparameters(
        depth=2, width=16, epochs=epochs, batch_size=batch_size)
    use_jax_init(monkeypatch, JTrunk((16, 16), NZ), (1, 3 * NZ), hp.seed)
    jm = jfit.train_precipitative_model(
        hp, batches, input_variables=PRECIP_IN, output_variables=PRECIP_OUT)
    tm = tfit.train_precipitative_model(
        tfit.PrecipitativeHyperparameters(**vars(hp)),
        [_as_port(b) for b in batches], input_variables=PRECIP_IN,
        output_variables=PRECIP_OUT, device="cpu")
    assert sorted(tm.module.flax_layers()) == sorted(jm.params)
    assert_params_close(jm.params, tm.module, rtol, f"{epochs} epochs")
    _predict_both(jm, tm, _precip_batch(7))


@pytest.mark.parametrize("epochs,ncubes,rtol", [
    (1, 1, STEP_RTOL), (3, 2, RUN_RTOL)])
def test_convolutional_training_matches_jax(monkeypatch, epochs, ncubes,
                                            rtol):
    batches = [_cube_batch(s) for s in range(ncubes)]
    hp = jfit.ConvolutionalHyperparameters(filters=8, depth=2,
                                           epochs=epochs)
    use_jax_init(monkeypatch, JCNN(8, 2, 3, NZ), (1, N + 4, N + 4, NZ),
                 hp.seed)
    jm = jfit.train_convolutional_model(
        hp, batches, input_variables=["a_in"], output_variables=["b_out"])
    tm = tfit.train_convolutional_model(
        tfit.ConvolutionalHyperparameters(**vars(hp)),
        [_as_port(b) for b in batches], input_variables=["a_in"],
        output_variables=["b_out"], device="cpu")
    assert tm.n_halo == jm.n_halo == 2
    assert_params_close(jm.params, tm.module, rtol, f"{epochs} epochs")
    _predict_both(jm, tm, _cube_batch(7))


def test_convolutional_two_dimensional_fields(monkeypatch):
    """A [6, y, x] input and output (channel width 0 in the dump's
    meta): the port's prediction keeps the JAX package's dims."""
    rng = np.random.RandomState(3)
    a = rng.randn(6, N, N).astype(np.float32)
    batch = {"a2": JQuantity(a, ("tile", "y", "x")),
             "b2": JQuantity(2.0 * a, ("tile", "y", "x"))}
    hp = jfit.ConvolutionalHyperparameters(filters=4, depth=1, epochs=2)
    use_jax_init(monkeypatch, JCNN(4, 1, 3, 1), (1, N + 2, N + 2, 1),
                 hp.seed)
    jm = jfit.train_convolutional_model(
        hp, [batch], input_variables=["a2"], output_variables=["b2"])
    tm = tfit.train_convolutional_model(
        tfit.ConvolutionalHyperparameters(**vars(hp)), [_as_port(batch)],
        input_variables=["a2"], output_variables=["b2"], device="cpu")
    assert tm.widths_out == jm.widths_out == {"b2": 0}
    _predict_both(jm, tm, batch)


@pytest.mark.parametrize("n_halo,channels", [(1, 1), (2, 3), (3, 2)])
def test_append_halos_matches_jax(n_halo, channels):
    """The port's append_halos on [6, y, x, c] equals the JAX package's
    bit for bit, in float32 and float64, and its gradient is the
    gather's transpose (every interior cell's cotangent plus the halo
    slots that copy it)."""
    from fv3net_tpu.fit import append_halos as japp

    rng = np.random.RandomState(n_halo)
    f = rng.randn(6, N, N, channels)
    for dtype in (np.float32, np.float64):
        want = np.asarray(japp(jnp.asarray(f.astype(dtype)), n_halo))
        got = tfit.append_halos(torch.as_tensor(f.astype(dtype)), n_halo)
        assert got.dtype == torch.as_tensor(f.astype(dtype)).dtype
        np.testing.assert_array_equal(got.numpy(), want)
    x = torch.as_tensor(f).requires_grad_(True)
    ct = torch.as_tensor(rng.randn(6, N + 2 * n_halo, N + 2 * n_halo,
                                   channels))
    (tfit.append_halos(x, n_halo) * ct).sum().backward()
    import jax

    _, vjp = jax.vjp(lambda a: japp(a, n_halo), jnp.asarray(f))
    (want,) = vjp(jnp.asarray(ct.numpy()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
