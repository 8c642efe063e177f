"""The f32 spread of ten Adam steps under 1-ulp input changes.

chip_smoke.py holds the card's first Adam steps against the CPU's by
fv3net_tpu_torch.parity.f32_rule: within F32_FACTOR of the spread
between the CPU's f32 run and runs from SPREAD_RUNS 1-ulp perturbations
of the training data, for the parameters and for the predictions on a
fixed batch.  These CPU cases check that such a hold has teeth, at a
small size: a run that sums in another order (each batch's rows reversed,
standing in for the card's summation order) stays within it, and a run
with a learning rate 1% off leaves it.  The transformed family learns
differences of two snapshots that are equal where nothing happened, so
its data move by ``parity.perturb_ulp_grouped``: both snapshots of a
field in the same direction.
"""

import re

import numpy as np
import pytest
import torch

from fv3net_tpu_torch import fit, parity
from fv3net_tpu_torch.convert import module_flax_params
from fv3net_tpu_torch.emulation import transforms as tr
from fv3net_tpu_torch.fit import _shared, transformed
from fv3net_tpu_torch.util.quantity import Quantity

torch.set_num_threads(1)

STEPS, NZ = 10, 8
DIMS = ("sample", "z")


def _waves(n):
    """Seeded smooth columns: two inputs and an output of them."""
    rng = np.random.RandomState(0)
    z = np.linspace(0.0, 1.0, NZ)
    a = 250.0 + 20.0 * rng.rand(n, 1) * np.cos(3.0 * z) + rng.randn(n, NZ)
    b = 1e-2 * rng.rand(n, 1) * np.exp(-3.0 * z)
    c = 1e-5 * (a - 250.0) * b / 1e-2 + 1e-7 * rng.randn(n, NZ)
    return {k: v.astype(np.float32) for k, v in
            (("a", a), ("b", b), ("c", c))}


def _gscond(n):
    """Columns with a gscond-like rule: condensation of a twentieth of the
    humidity where T < 270, nothing elsewhere."""
    rng = np.random.RandomState(0)
    t_in = 240.0 + 50.0 * rng.rand(n, NZ)
    qv_in = 1e-3 * rng.rand(n, NZ)
    cloud_in = 1e-4 * rng.rand(n, NZ)
    cond = np.where(t_in < 270.0, 0.05 * qv_in, 0.0)
    out = {tr.T_INPUT: t_in, tr.QV_INPUT: qv_in, tr.CLOUD_INPUT: cloud_in,
           tr.T_GSCOND: t_in + cond * tr.LATENT_HEAT / tr.SPECIFIC_HEAT,
           tr.QV_GSCOND: qv_in - cond, tr.CLOUD_GSCOND: cloud_in + cond}
    return {k: v.astype(np.float32) for k, v in out.items()}


def _dense(rows, lr):
    return fit.train_dense_model(
        fit.DenseHyperparameters(depth=2, width=32, epochs=1,
                                 batch_size=128, learning_rate=lr),
        [{k: Quantity(v, DIMS) for k, v in rows.items()}],
        input_variables=["a", "b"], output_variables=["c"], device="cpu")


def _transformed(rows, lr):
    hp = transformed.TransformedParameters.from_dict(dict(
        tensor_transform=[
            {"kind": "log", "source": tr.CLOUD_INPUT,
             "to": "log_cloud_input", "epsilon": 1e-10},
            {"to": "tdiff", "before": tr.T_INPUT, "after": tr.T_GSCOND},
            {"to": "qvdiff", "before": tr.QV_INPUT, "after": tr.QV_GSCOND},
        ],
        model={"input_variables": [tr.T_INPUT, tr.QV_INPUT,
                                   "log_cloud_input"],
               "direct_out_variables": ["tdiff", "qvdiff"],
               "architecture": {"name": "dense", "depth": 2, "width": 64}},
        loss={"loss_variables": ["tdiff", "qvdiff"]},
        epochs=1, batch_size=256, learning_rate=lr))
    return transformed.train_transformed(hp, [rows], device="cpu")


def _field(name):
    return re.sub("_(input|after_gscond)$", "", name)


FAMILIES = {
    # family: (data, batch, train, inputs, perturbation)
    "dense": (_waves, 128, _dense, ("a", "b"), parity.perturb_ulp),
    "transformed": (
        _gscond, 256, _transformed,
        (tr.T_INPUT, tr.QV_INPUT, tr.CLOUD_INPUT),
        lambda rows, seed: parity.perturb_ulp_grouped(rows, seed, _field)),
}


def _outputs(model, fixed):
    params = {f"{layer}.{k}": torch.as_tensor(v)
              for layer, p in module_flax_params(model.module).items()
              for k, v in p.items()}
    preds = {k: torch.as_tensor(np.asarray(q.data))
             for k, q in model.predict(fixed).items()}
    return params, preds


def _worst(candidate, runs, cpu):
    """max err / bound of parity.f32_rule over the parameters and over
    the predictions."""
    return [max(err / bound for err, bound, *_ in parity.f32_rule(
        candidate[i], [r[i] for r in runs], cpu[i]).values())
        for i in (0, 1)]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_training_hold_sees_a_one_percent_learning_rate_fault(
        family, monkeypatch):
    data, batch, train, inputs, perturb = FAMILIES[family]
    all_rows = data(STEPS * batch + 512)
    rows = {k: v[: STEPS * batch] for k, v in all_rows.items()}
    fixed = {k: Quantity(all_rows[k][-512:], DIMS) for k in inputs}
    cpu = _outputs(train(rows, 1e-3), fixed)
    runs = [_outputs(train(perturb(rows, seed), 1e-3), fixed)
            for seed in range(parity.SPREAD_RUNS)]
    fault = _worst(_outputs(train(rows, 1.01e-3), fixed), runs, cpu)
    real = _shared.train_step
    monkeypatch.setattr(_shared, "train_step", lambda m, o, f, b: real(
        m, o, f, tuple(t.flip(0) for t in b)))
    reordered = _worst(_outputs(train(rows, 1e-3), fixed), runs, cpu)
    print(family, "reordered", reordered, "lr x 1.01", fault)
    assert max(reordered) <= 1.0, reordered
    assert min(fault) > 1.0, fault


def test_perturb_ulp_grouped_moves_a_field_together():
    rng = np.random.RandomState(1)
    before = (250.0 + rng.rand(40, 6)).astype(np.float32)
    after = np.where(rng.rand(40, 6) < 0.5, before, before + 0.25)
    rows = {"t_input": before, "t_after_gscond": after.astype(np.float32),
            "q_input": (1e-3 * rng.rand(40, 6)).astype(np.float32)}
    moved = parity.perturb_ulp_grouped(rows, 3, _field)
    for k, x in rows.items():
        up = np.nextafter(x, np.float32(np.inf))
        down = np.nextafter(x, np.float32(-np.inf))
        assert moved[k].dtype == np.float32, k
        assert np.all((moved[k] == up) | (moved[k] == down)), k
    same = rows["t_input"] == rows["t_after_gscond"]
    np.testing.assert_array_equal(moved["t_input"][same],
                                  moved["t_after_gscond"][same])
    t_up = moved["t_input"] > rows["t_input"]
    q_up = moved["q_input"] > rows["q_input"]
    assert np.array_equal(
        t_up, moved["t_after_gscond"] > rows["t_after_gscond"])
    assert 0.3 < np.mean(t_up) < 0.7
    assert not np.array_equal(t_up, q_up)
