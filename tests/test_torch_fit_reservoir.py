"""The port's reservoir family against the JAX package's, on the JAX
package's reservoir matrices (carried across: the port draws its own
from a torch.Generator): the subdomain split and merge, one echo-state
increment, the states of the scan over T = 40, the ridge readout, the
trained model's predictions after ``synchronize``, and dumps loading
across.

Tolerances.  The split and merge are copies: bit for bit.  The increment
and the scan run in float32 in both packages (their products sum in
other orders): STATE_RTOL of the states' magnitude.  The ridge solve in
float64 agrees to RIDGE64_RTOL; in float32 its solution is held by its
objective, ||S W - Y||^2 + lam ||W||^2 in float64, which the port's W
meets within OBJECTIVE_RATIO of the JAX package's (element by element
the two solutions need not agree where S^T S is near singular).
Predictions: PRED_RTOL of each output's magnitude.  Measured values are
in each test's docstring."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu import fit as jfit
from fv3net_tpu.fit import reservoir as jrsv
from fv3net_tpu.util.quantity import Quantity as JQuantity
from fv3net_tpu_torch import fit as tfit
from fv3net_tpu_torch.fit import reservoir as trsv
from fv3net_tpu_torch.util.quantity import Quantity as TQuantity
from test_fit_families import N
from torch_parity import assert_close_scaled

torch.set_num_threads(1)

STATE_RTOL = 1e-6
RIDGE64_RTOL = 1e-10
OBJECTIVE_RATIO = 1.01
PRED_RTOL = 1e-4
T = 40


def _as_port(batch):
    return {k: TQuantity(np.asarray(q.data), q.dims, q.units)
            for k, q in batch.items()}


def _series(T=T):
    """A slowly rotating wave (a 2D field) and a two-level field that
    lags it (3D): each step predictable from the last."""
    yy, xx = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    out = []
    for t in range(T):
        f = np.sin(2 * np.pi * (xx[None] + 0.5 * t) / N) * np.ones((6, 1, 1))
        g = np.stack([np.cos(2 * np.pi * (yy + 0.3 * t) / N + face)
                      for face in range(6)])[:, None] * np.array(
                          [1.0, 0.5])[None, :, None, None]
        out.append({
            "f": JQuantity(f.astype(np.float32), ("tile", "y", "x"), ""),
            "g": JQuantity(g.astype(np.float32), ("tile", "z", "y", "x"), ""),
        })
    return out


HP = dict(state_size=64, burn_in=5, subdomain_layout=(2, 2), overlap=1,
          seed=0)


@pytest.mark.parametrize("layout,overlap", [((2, 2), 0), ((2, 2), 1),
                                            ((1, 2), 2), ((4, 2), 1)])
def test_rank_divider_matches_jax(layout, overlap):
    """Subdomains with their overlap (edge-padded at the tile's edges, the
    JAX package's quirk) and the merge of interiors, bit for bit, for
    [6, y, x] and [6, z, y, x] fields."""
    rng = np.random.RandomState(0)
    want_d = jrsv.RankDivider(layout, N, N, overlap)
    got_d = trsv.RankDivider(layout, N, N, overlap)
    for shape in ((6, N, N), (6, 3, N, N)):
        f = rng.randn(*shape).astype(np.float32)
        subs = got_d.subdomains_with_overlap(f)
        np.testing.assert_array_equal(subs, want_d.subdomains_with_overlap(f))
        inner = trsv.RankDivider(layout, N, N, 0).subdomains_with_overlap(f)
        np.testing.assert_array_equal(got_d.merge_subdomains(inner), f)
        np.testing.assert_array_equal(got_d.merge_subdomains(inner),
                                      want_d.merge_subdomains(inner))


def _jax_reservoir(n_input):
    return jrsv.Reservoir(jfit.ReservoirHyperparameters(**HP), n_input)


def _port_reservoir(jres):
    return trsv.Reservoir.from_arrays(
        tfit.ReservoirHyperparameters(**HP), np.asarray(jres.W_res),
        np.asarray(jres.W_in), "cpu")


def test_reservoir_draws_and_increment():
    """The port's own draws: W_res has the requested spectral radius and
    sparsity, W_in the input scaling (float32, seeded, repeatable).  One
    increment with the JAX package's matrices equals the JAX package's.
    Measured: <= 1.2e-7 of the state."""
    hp = tfit.ReservoirHyperparameters(**HP)
    res = trsv.Reservoir(hp, 30, device="cpu")
    again = trsv.Reservoir(hp, 30, device="cpu")
    assert torch.equal(res.W_in, again.W_in)
    assert torch.equal(res.W_res, again.W_res)
    assert res.W_res.dtype == res.W_in.dtype == torch.float32
    radius = np.abs(np.linalg.eigvals(res.W_res.double().numpy())).max()
    assert abs(radius - hp.spectral_radius) < 1e-6
    assert 0.02 < float((res.W_res != 0).float().mean()) < 0.08
    assert float(res.W_in.abs().max()) <= hp.input_scaling

    jres = _jax_reservoir(30)
    rng = np.random.RandomState(1)
    u = rng.randn(24, 30).astype(np.float32)
    x = np.tanh(rng.randn(24, hp.state_size)).astype(np.float32)
    want = np.asarray(jres.increment_state(jnp.asarray(u), jnp.asarray(x)))
    got = _port_reservoir(jres).increment_state(torch.as_tensor(u),
                                                torch.as_tensor(x))
    assert_close_scaled(got.numpy(), want, STATE_RTOL, "increment")


def _normalised():
    hp = jfit.ReservoirHyperparameters(**HP)
    return trsv.normalised_series(hp, _series(), ["f", "g"], ["f", "g"])


def test_scan_states_match_jax():
    """The echo states of the normalised series (T = 40, 24 subdomain
    rows of 300 inputs) from the Python loop against ``lax.scan``.
    Measured: <= 2.9e-7 of the states."""
    _, Un, _, _, _, _ = _normalised()
    jres = _jax_reservoir(Un.shape[-1])
    _, want = jax.lax.scan(
        lambda x, u: (jres.increment_state(u, x),) * 2,
        jnp.zeros((Un.shape[1], HP["state_size"]), jnp.float32),
        jnp.asarray(Un))
    got = trsv.reservoir_states(_port_reservoir(jres), torch.as_tensor(Un))
    assert got.shape == (T, Un.shape[1], HP["state_size"])
    assert_close_scaled(got.numpy(), np.asarray(want), STATE_RTOL, "states")


def _objective(S, W, Y, lam):
    S, W, Y = (np.asarray(a, np.float64) for a in (S, W, Y))
    return float(((S @ W - Y) ** 2).sum() + lam * (W ** 2).sum())


@pytest.mark.parametrize("rows", [300, 100])
def test_ridge_fit_matches_jax(rows):
    """The readout of 128 quadratic features.  With more rows than
    features (300) the float64 solves agree element by element (measured:
    <= 6.4e-15 of W).  With fewer (100), S^T S is singular up to lam and
    W is roundoff of the solve (the float64 solves differ by 1.7e-8 of W):
    there, and in float32 in both cases, the port's W is held by the ridge
    objective against the JAX package's (measured: the port's objective /
    the JAX package's 1.0000000 in float64 and at 300 rows in float32,
    0.887 at 100 rows in float32, where the two W differ by 1.09 of their
    magnitude)."""
    rng = np.random.RandomState(rows)
    x = np.tanh(rng.randn(rows, 64))
    S = np.concatenate([x, x * x], axis=1)
    Y = rng.randn(rows, 7)
    lam = 1e-6
    for dtype in (np.float64, np.float32):
        Sd, Yd = S.astype(dtype), Y.astype(dtype)
        want = np.asarray(jrsv.ridge_fit(jnp.asarray(Sd), jnp.asarray(Yd),
                                         lam))
        got = trsv.ridge_fit(torch.as_tensor(Sd), torch.as_tensor(Yd),
                             lam).numpy()
        assert got.dtype == dtype and np.isfinite(got).all()
        if dtype == np.float64 and rows > S.shape[1]:
            assert_close_scaled(got, want, RIDGE64_RTOL, "ridge f64")
        ratio = _objective(S, got, Y, lam) / _objective(S, want, Y, lam)
        assert ratio <= OBJECTIVE_RATIO, (dtype, ratio)


def _train_both(monkeypatch):
    """Both packages' trained models on the series, the port's from the
    JAX package's reservoir matrices."""
    series = _series()
    hp = jfit.ReservoirHyperparameters(**HP)
    jm = jfit.train_reservoir_model(hp, series, input_variables=["f", "g"],
                                    output_variables=["f", "g"])
    real = trsv.Reservoir
    monkeypatch.setattr(
        trsv, "Reservoir",
        lambda hp, n, device: real.from_arrays(
            hp, np.asarray(jm.reservoir.W_res),
            np.asarray(jm.reservoir.W_in), device))
    tm = tfit.train_reservoir_model(
        tfit.ReservoirHyperparameters(**HP), [_as_port(b) for b in series],
        input_variables=["f", "g"], output_variables=["f", "g"],
        device="cpu")
    monkeypatch.setattr(trsv, "Reservoir", real)
    return jm, tm, series


def _predict_after_sync(model, series, port):
    wrap = _as_port if port else (lambda b: b)
    model.synchronize([wrap(b) for b in series[:-2]])
    return {k: np.asarray(q.values)
            for k, q in model.predict(wrap(series[-2])).items()}


def test_trained_model_matches_jax(monkeypatch):
    """Trained on the same series from the same matrices: after
    ``synchronize`` on all but the last two steps, the prediction of the
    last step; and it beats persistence (the last step but one).
    Measured: <= 3.2e-5 of each output (W_out is a float32 solve of a
    system with condition ~1e6)."""
    jm, tm, series = _train_both(monkeypatch)
    assert isinstance(tm.W_out, torch.Tensor)
    want = _predict_after_sync(jm, series, False)
    got = _predict_after_sync(tm, series, True)
    for k in want:
        assert_close_scaled(got[k], want[k], PRED_RTOL, k)
        truth = np.asarray(series[-1][k].values)
        persistence = np.abs(np.asarray(series[-2][k].values) - truth).mean()
        assert np.abs(got[k] - truth).mean() < persistence, k
    assert got["f"].shape == (6, N, N) and got["g"].shape == (6, 2, N, N)


def test_reservoir_dumps_cross_both_ways(tmp_path, monkeypatch):
    """A JAX dump (``arrays.npz``, ``meta.json``) loads in the port and
    predicts the same after ``synchronize``, and the port writes the same
    arrays back bit for bit; a port dump loads in the JAX package and
    predicts the same.  Measured: <= 2.4e-7 of each output."""
    jm, tm, series = _train_both(monkeypatch)
    jfit.dump(jm, str(tmp_path / "jax"))
    loaded = tfit.load(str(tmp_path / "jax"), "cpu")
    assert isinstance(loaded, tfit.ReservoirComputingModel)
    want = _predict_after_sync(jm, series, False)
    got = _predict_after_sync(loaded, series, True)
    for k in want:
        assert_close_scaled(got[k], want[k], PRED_RTOL, f"jax->port {k}")
    tfit.dump(loaded, str(tmp_path / "again"))
    with np.load(tmp_path / "again" / "arrays.npz") as a, \
            np.load(tmp_path / "jax" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    tfit.dump(tm, str(tmp_path / "port"))
    back = jfit.load(str(tmp_path / "port"))
    want = _predict_after_sync(tm, series, True)
    got = _predict_after_sync(back, series, False)
    for k in want:
        assert_close_scaled(got[k], want[k], PRED_RTOL, f"port->jax {k}")
