"""The port's generative families (autoencoder and CycleGAN) against the
JAX package's: every SAME convolution and transposed convolution against
flax's on random inputs, one Adam step and a short run from the JAX
package's initial parameters (carried across by convert.py), the
predictions of the trained models, and dumps loading across.

Tolerances.  A flax layer and the port's in float64 sum in other orders:
CONV_RTOL 1e-12 of the output's magnitude.  Training runs in float32 in
both packages; one step agrees to STEP_RTOL, a short run to RUN_RTOL of
each array's magnitude, and the predictions to PRED_RTOL of each
output's (the measured values are in each test's docstring)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from fv3net_tpu import fit as jfit
from fv3net_tpu.fit.generative import _AE as JAE
from fv3net_tpu.fit.generative import _Discriminator as JDisc
from fv3net_tpu.fit.generative import _Generator as JGen
from fv3net_tpu.util.quantity import Quantity as JQuantity
from fv3net_tpu_torch import fit as tfit
from fv3net_tpu_torch.fit import generative as tgen
from fv3net_tpu_torch.util.quantity import Quantity as TQuantity
from test_fit_families import N, NZ, _cube_batch
from torch_parity import (
    assert_close_scaled,
    assert_params_close,
    use_jax_init,
    use_jax_inits,
)

torch.set_num_threads(1)

CONV_RTOL = 1e-12
STEP_RTOL = 1e-6
RUN_RTOL = 1e-5
PRED_RTOL = 1e-5


def _as_port(batch):
    return {k: TQuantity(np.asarray(q.data), q.dims, q.units)
            for k, q in batch.items()}


def _predict_both(jm, tm, x):
    want = jm.predict(x)
    got = tm.predict(_as_port(x))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dims == want[k].dims, k
        assert_close_scaled(got[k].values, want[k].values, PRED_RTOL, k)


def _flax_layer(layer, shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape)
    params = layer.init(jax.random.PRNGKey(seed), jnp.zeros(shape))["params"]
    params = {k: jnp.asarray(rng.randn(*v.shape)) for k, v in params.items()}
    want = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
    return x, {k: np.asarray(v) for k, v in params.items()}, want


def _port_layer(module, params, x):
    from fv3net_tpu_torch.convert import module_from_flax

    module = module.double()
    module.flax_layers = lambda: {"layer": module}
    module_from_flax(module, {"layer": params})
    with torch.no_grad():
        got = module(torch.as_tensor(x).permute(0, 3, 1, 2))
    return got.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("k,s,n", [
    (3, 2, 48), (4, 2, 48), (4, 1, 48), (3, 2, 7), (4, 2, 9), (4, 1, 7),
    (3, 1, 8), (1, 1, 8), (2, 2, 5)])
def test_same_conv_matches_flax(k, s, n):
    """``_SameConv2d`` is flax's ``Conv(padding="SAME")``, the split of
    lax's padding included: at n = 48 (0, 1) for k 3 s 2, (1, 1) for k 4
    s 2, (1, 2) for k 4 s 1.  Measured: <= 1.4e-16 of the output."""
    layer = flax_nn.Conv(5, (k, k), strides=(s, s), padding="SAME")
    x, params, want = _flax_layer(layer, (2, n, n, 3), k * 10 + s + n)
    got = _port_layer(tgen._SameConv2d(3, 5, k, s), params, x)
    assert got.shape == want.shape
    assert_close_scaled(got, want, CONV_RTOL, f"conv k{k} s{s} n{n}")
    if n == 48:
        assert tgen.same_pads(n, k, s) == {
            (3, 2): (0, 1), (4, 2): (1, 1), (4, 1): (1, 2)}[(k, s)]


@pytest.mark.parametrize("k,s,n", [
    (3, 2, 12), (3, 2, 7), (4, 2, 8), (4, 2, 5), (3, 1, 6), (2, 2, 6),
    (1, 2, 5)])
def test_conv_transpose_matches_flax(k, s, n):
    """``_ConvTranspose2d`` is flax's ``ConvTranspose(padding="SAME")``
    with the flax kernel loaded as it is (no flip, no channel swap).
    Measured: <= 3.8e-16 of the output."""
    layer = flax_nn.ConvTranspose(5, (k, k), strides=(s, s), padding="SAME")
    x, params, want = _flax_layer(layer, (2, n, n, 3), k * 10 + s + n)
    got = _port_layer(tgen._ConvTranspose2d(3, 5, k, s), params, x)
    assert got.shape == want.shape == (2, n * s, n * s, 5)
    assert_close_scaled(got, want, CONV_RTOL, f"transpose k{k} s{s} n{n}")


def _ae_hp(pkg, epochs):
    f = jfit if pkg == "jax" else tfit
    return f.AutoencoderHyperparameters(filters=4, depth=2, latent=3,
                                        epochs=epochs)


@pytest.mark.parametrize("epochs,rtol", [(1, STEP_RTOL), (5, RUN_RTOL)])
def test_autoencoder_training_matches_jax(monkeypatch, epochs, rtol):
    """One Adam step and five (the whole batch a step) from the JAX
    package's init: the parameters, the reconstruction and the latent
    code.  Measured: parameters <= 2.4e-7 (one step) and 9.6e-7 (five) of
    each array, predictions <= 2.2e-7 of the output, latent <= 8.8e-8."""
    batches = [_cube_batch(s) for s in range(2)]
    hp = _ae_hp("jax", epochs)
    use_jax_init(monkeypatch, JAE(hp.filters, hp.depth, hp.latent, NZ),
                 (1, N, N, NZ), hp.seed)
    jm = jfit.train_autoencoder(hp, batches, input_variables=["a_in"])
    tm = tfit.train_autoencoder(_ae_hp("torch", epochs),
                                [_as_port(b) for b in batches],
                                input_variables=["a_in"], device="cpu")
    assert_params_close(jm.params, tm.module, rtol, f"{epochs} epochs")
    x = _cube_batch(7)
    _predict_both(jm, tm, x)
    assert_close_scaled(tm.encode(_as_port(x)), jm.encode(x), PRED_RTOL,
                        "encode")


def _cycle_batches(ncubes=2):
    rng = np.random.RandomState(0)
    dims = ("tile", "z", "y", "x")
    out = []
    for _ in range(ncubes):
        a = rng.randn(6, 2, N, N).astype(np.float32)
        out.append({"coarse": JQuantity(a, dims),
                    "fine": JQuantity(
                        (1.5 * a + 1.0 + 0.1 * rng.randn(*a.shape)).astype(
                            np.float32), dims)})
    return out


def _cyclegan_jax_init(hp, c):
    """The JAX package's four initial parameter sets (train_cyclegan's
    split keys), in the port's init order: G_ab, G_ba, D_a, D_b."""
    ks = jax.random.split(jax.random.PRNGKey(hp.seed), 4)
    x0 = jnp.zeros((1, N, N, c), jnp.float32)
    gen, disc = JGen(hp.filters, hp.n_res, c), JDisc(hp.filters)
    return [m.init(key, x0)["params"]
            for m, key in zip((gen, gen, disc, disc), ks)]


def _cyclegan_hp(pkg, epochs):
    f = jfit if pkg == "jax" else tfit
    return f.CycleGANHyperparameters(filters=4, n_res=1, epochs=epochs)


@pytest.mark.parametrize("epochs,rtol", [(1, STEP_RTOL), (3, RUN_RTOL)])
def test_cyclegan_training_matches_jax(monkeypatch, epochs, rtol):
    """The generator step and the discriminator step in turn (Adam b1
    0.5), one round and three, from the JAX package's four inits: both
    generators' parameters and the A->B prediction.  Measured:
    parameters <= 1.5e-7 (one round) and 1.9e-7 (three) of each array,
    predictions <= 1.2e-7 of the output."""
    batches = _cycle_batches()
    hp = _cyclegan_hp("jax", epochs)
    use_jax_inits(monkeypatch, _cyclegan_jax_init(hp, 2))
    jm = jfit.train_cyclegan(hp, batches, input_variables=["coarse"],
                             output_variables=["fine"])
    tm = tfit.train_cyclegan(_cyclegan_hp("torch", epochs),
                             [_as_port(b) for b in batches],
                             input_variables=["coarse"],
                             output_variables=["fine"], device="cpu")
    assert_params_close(jm.params_ab, tm.gen_ab, rtol, "G_ab")
    assert_params_close(jm.params_ba, tm.gen_ba, rtol, "G_ba")
    _predict_both(jm, tm, _cycle_batches(1)[0])


def _train(name, pkg):
    f = jfit if pkg == "jax" else tfit
    kw = {} if pkg == "jax" else {"device": "cpu"}
    wrap = (lambda b: b) if pkg == "jax" else _as_port
    if name == "autoencoder":
        return f.train_autoencoder(
            _ae_hp(pkg, 2), [wrap(_cube_batch(s)) for s in range(2)],
            input_variables=["a_in"], **kw), _cube_batch(5)
    return f.train_cyclegan(
        _cyclegan_hp(pkg, 2), [wrap(b) for b in _cycle_batches()],
        input_variables=["coarse"], output_variables=["fine"],
        **kw), _cycle_batches(1)[0]


def _predictions(model, x):
    return {k: np.asarray(q.values) for k, q in model.predict(x).items()}


@pytest.mark.parametrize("name", ["autoencoder", "cyclegan"])
def test_generative_dumps_cross_both_ways(tmp_path, name):
    """A JAX dump loads in the port (``fit.load``) and predicts the same,
    and the port writes the same parameter files back bit for bit; a port
    dump loads in the JAX package and predicts the same.  Measured:
    <= 2.2e-7 of the output."""
    files = ["params.npy"] if name == "autoencoder" else [
        "params_ab.npy", "params_ba.npy"]
    jm, x = _train(name, "jax")
    jfit.dump(jm, str(tmp_path / "jax"))
    tm = tfit.load(str(tmp_path / "jax"), "cpu")
    assert type(tm).__name__ == type(jm).__name__
    want, got = _predictions(jm, x), _predictions(tm, _as_port(x))
    for k in want:
        assert_close_scaled(got[k], want[k], PRED_RTOL, f"jax->port {k}")
    tfit.dump(tm, str(tmp_path / "again"))
    for f in files:
        np.testing.assert_array_equal(np.load(tmp_path / "again" / f),
                                      np.load(tmp_path / "jax" / f))

    tm, x = _train(name, "torch")
    tfit.dump(tm, str(tmp_path / "port"))
    jm = jfit.load(str(tmp_path / "port"))
    want = _predictions(tm, _as_port(x))
    got = _predictions(jm, x)
    for k in want:
        assert_close_scaled(got[k], want[k], PRED_RTOL, f"port->jax {k}")
