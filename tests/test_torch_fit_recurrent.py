"""The port's recurrent family (full-model replacement, ``fmr``) against
the JAX package's: the gated cell against flax's, one Adam step and a
short run from the JAX package's initial parameters (carried across by
convert.py), with teacher forcing every step and every second step,
``predict`` and ``predict_rollout`` of the trained models, and dumps
loading across.

Tolerances.  The cell in float64: CELL_RTOL 1e-12 of its output.
Training runs in float32 in both packages: one step agrees to STEP_RTOL,
a short run to RUN_RTOL of each array's magnitude, the predictions to
PRED_RTOL of each output's (measured values in each test's docstring)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu import fit as jfit
from fv3net_tpu.fit.recurrent import _FMRCore as JCore
from fv3net_tpu.fit.recurrent import _GRUCell as JCell
from fv3net_tpu_torch import fit as tfit
from fv3net_tpu_torch.convert import module_from_flax
from fv3net_tpu_torch.fit import recurrent as trec
from fv3net_tpu_torch.util.quantity import Quantity as TQuantity
from test_fit_families import N, _time_series
from torch_parity import (
    assert_close_scaled,
    assert_params_close,
    flax_numpy,
    use_jax_inits,
)

torch.set_num_threads(1)

CELL_RTOL = 1e-12
STEP_RTOL = 1e-6
RUN_RTOL = 1e-5
PRED_RTOL = 1e-5
HIDDEN = 16


def _as_port(batch):
    return {k: TQuantity(np.asarray(q.data), q.dims, q.units)
            for k, q in batch.items()}


def test_gru_cell_matches_flax():
    """``_GRUCell`` (three nn.Linear layers) is the JAX package's cell on
    random float64 inputs and parameters, not torch.nn.GRUCell.
    Measured: <= 6.4e-16 of the output."""
    rng = np.random.RandomState(0)
    h, x = rng.randn(5, 7), rng.randn(5, 3)
    jcell = JCell(7)
    params = jcell.init(jax.random.PRNGKey(0), jnp.asarray(h),
                        jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape)), params)
    want = np.asarray(jcell.apply({"params": params}, jnp.asarray(h),
                                  jnp.asarray(x)))
    cell = trec._GRUCell(3, 7).double()
    module_from_flax(cell, flax_numpy(params))
    with torch.no_grad():
        got = cell(torch.as_tensor(h), torch.as_tensor(x)).numpy()
    assert_close_scaled(got, want, CELL_RTOL, "cell")


def _jax_init(hp, n_state, n_forcing):
    cols = 6 * N * N
    return JCore(hp.hidden, n_state).init(
        jax.random.PRNGKey(hp.seed), jnp.zeros((cols, hp.hidden)),
        jnp.zeros((cols, n_state), jnp.float32),
        jnp.zeros((cols, n_forcing), jnp.float32))["params"]


def _train_both(monkeypatch, epochs, train_rollout, T=12):
    batches, f, s = _time_series(T=T)
    kw = dict(hidden=HIDDEN, epochs=epochs, learning_rate=3e-3,
              train_rollout=train_rollout)
    hp = jfit.FMRHyperparameters(**kw)
    params = _jax_init(hp, 2, 2)
    use_jax_inits(monkeypatch, [params])
    jm = jfit.train_fmr_model(hp, batches, input_variables=["forcing"],
                              output_variables=["state"])
    tm = tfit.train_fmr_model(tfit.FMRHyperparameters(**kw),
                              [_as_port(b) for b in batches],
                              input_variables=["forcing"],
                              output_variables=["state"], device="cpu")
    return jm, tm, batches, f, s


@pytest.mark.parametrize("epochs,train_rollout,rtol", [
    (1, 1, STEP_RTOL), (20, 2, RUN_RTOL)])
def test_fmr_training_matches_jax(monkeypatch, epochs, train_rollout, rtol):
    """One Adam step (11 unrolled steps, teacher-forced every step) and
    twenty (free-running two steps between restarts from the data): the
    parameters, ``predict`` and ``predict_rollout`` over the series.
    Measured: parameters <= 3.1e-7 (one step) and 1.5e-6 (twenty) of each
    array, predictions <= 2.4e-7 of the output."""
    jm, tm, batches, f, s = _train_both(monkeypatch, epochs, train_rollout)
    assert_params_close(jm.params, tm.module, rtol, f"{epochs} epochs")
    want, got = jm.predict(batches[3]), tm.predict(_as_port(batches[3]))
    assert got["state"].dims == want["state"].dims
    assert isinstance(got["state"].data, np.ndarray)
    assert_close_scaled(got["state"].values, want["state"].values,
                        PRED_RTOL, "predict")
    cols = 6 * N * N
    s0 = s[0].transpose(0, 2, 3, 1).reshape(cols, 2)
    ff = f.transpose(0, 1, 3, 4, 2).reshape(len(f), cols, 2)
    assert_close_scaled(tm.predict_rollout(s0, ff),
                        jm.predict_rollout(s0, ff), PRED_RTOL, "rollout")


def test_fmr_learns_forced_linear_dynamics(tmp_path, monkeypatch):
    """The port's counterpart of the JAX package's slow test of the same
    name, at a few epochs: thirty Adam steps on s' = 0.9 s + 0.5 f cut the
    one-step error of the first step's model, and the model predicts the
    same after a dump and a load."""
    jm, first, batches, _, s = _train_both(monkeypatch, 1, 1)
    _, tm, _, _, _ = _train_both(monkeypatch, 30, 1)
    x = _as_port(batches[3])
    err = [np.mean((m.predict(x)["state"].values - s[4]) ** 2)
           for m in (first, tm)]
    assert err[1] < 0.7 * err[0], err
    tfit.dump(tm, str(tmp_path / "fmr"))
    np.testing.assert_array_equal(
        tfit.load(str(tmp_path / "fmr"), "cpu").predict(x)["state"].values,
        tm.predict(x)["state"].values)


def test_fmr_dumps_cross_both_ways(tmp_path, monkeypatch):
    """A JAX dump loads in the port (``fit.load``), predicts the same and
    writes the same params.npy back bit for bit; a port dump loads in the
    JAX package and predicts the same.  Measured: <= 1.2e-7."""
    jm, tm, batches, _, _ = _train_both(monkeypatch, 2, 1, T=6)
    jfit.dump(jm, str(tmp_path / "jax"))
    loaded = tfit.load(str(tmp_path / "jax"), "cpu")
    assert isinstance(loaded, tfit.FMRModel)
    x = batches[2]
    assert_close_scaled(loaded.predict(_as_port(x))["state"].values,
                        jm.predict(x)["state"].values, PRED_RTOL, "jax->port")
    tfit.dump(loaded, str(tmp_path / "again"))
    np.testing.assert_array_equal(np.load(tmp_path / "again" / "params.npy"),
                                  np.load(tmp_path / "jax" / "params.npy"))
    tfit.dump(tm, str(tmp_path / "port"))
    back = jfit.load(str(tmp_path / "port"))
    assert_close_scaled(back.predict(x)["state"].values,
                        tm.predict(_as_port(x))["state"].values, PRED_RTOL,
                        "port->jax")
