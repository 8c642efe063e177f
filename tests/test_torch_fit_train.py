"""The port's training (fv3net_tpu_torch.fit) against the JAX package's:
Adam steps of the dense family from the same initial parameters (the
port's init replaced by the JAX package's, carried across by convert.py),
the registries, the train CLI of both packages on the same YAML files,
dumps that cross between the packages in both directions for every
ported family, and the numpy models (min/max novelty detector, the
composite wrappers).

Tolerances.  Both packages train in float32 and their matmuls sum in
other orders, so one Adam step agrees to ~1e-8 of each layer's kernel
(measured 1.3e-8): STEP_RTOL 1e-6.  Over two epochs (14 steps) Adam's
normalised updates carry the roundoff along (measured 8.6e-8):
TRAIN_RTOL 1e-6.  Predictions run the float32 network in both packages:
PRED_RTOL 1e-5 of each output's magnitude (measured 2.5e-7)."""

import json

import numpy as np
import pytest
import torch
import yaml

import fv3net_tpu.fit.transformed  # noqa: F401  (registers "transformed")
from fv3net_tpu import fit as jfit
from fv3net_tpu.data import SyntheticWaves
from fv3net_tpu.fit.dense import _MLP as JMLP
from fv3net_tpu.util.quantity import Quantity as JQuantity
from fv3net_tpu_torch import fit as tfit
from fv3net_tpu_torch.convert import module_to_flat
from fv3net_tpu_torch.util.quantity import Quantity as TQuantity
from test_fit_families import _cube_batch, _precip_batch
from test_transformed_training import _synthetic_gscond_batch, _train_config
from torch_parity import assert_close_scaled, assert_params_close, use_jax_init

torch.set_num_threads(1)

STEP_RTOL = 1e-6
TRAIN_RTOL = 1e-6
PRED_RTOL = 1e-5
IN, OUT = ["a_in", "b_in"], ["c_out"]
NZ = 5


def _waves(nbatch=2, seed=1):
    return SyntheticWaves(IN + OUT, n=6, nz=NZ, nbatch=nbatch,
                          seed=seed).batches()


def _as_port(batch):
    """A JAX-package batch (Quantity dict, or a dict of arrays) with the
    port's Quantity."""
    return {
        k: TQuantity(np.asarray(q.data), q.dims, q.units)
        if isinstance(q, JQuantity) else q
        for k, q in batch.items()
    }


def _train_both(monkeypatch, hp, batches):
    """The dense family trained by both packages from the JAX package's
    initial parameters."""
    use_jax_init(monkeypatch, JMLP((hp.width,) * hp.depth, NZ),
                 (1, 2 * NZ), hp.seed)
    jm = jfit.train_dense_model(hp, batches, input_variables=IN,
                                output_variables=OUT)
    tm = tfit.train_dense_model(
        tfit.DenseHyperparameters(**vars(hp)),
        [_as_port(b) for b in batches], input_variables=IN,
        output_variables=OUT, device="cpu",
    )
    return jm, tm


def test_one_adam_step_matches_jax(monkeypatch):
    """One batch holding every sample, one epoch: one Adam step from the
    same parameters on the same batch."""
    batches = _waves()
    hp = jfit.DenseHyperparameters(depth=2, width=16, epochs=1,
                                   batch_size=2 * 6 * 36)
    jm, tm = _train_both(monkeypatch, hp, batches)
    assert_params_close(jm.params, tm.module, STEP_RTOL, "one step")
    np.testing.assert_array_equal(tm.scaler_in.mean, jm.scaler_in.mean)
    np.testing.assert_array_equal(tm.scaler_out.std, jm.scaler_out.std)


def test_two_epochs_match_jax(monkeypatch):
    """Two epochs of 7 batches of 64 samples on SyntheticWaves, shuffled
    by the same RandomState permutations: parameters and predictions."""
    batches = _waves()
    hp = jfit.DenseHyperparameters(depth=2, width=16, epochs=2,
                                   batch_size=64)
    jm, tm = _train_both(monkeypatch, hp, batches)
    assert_params_close(jm.params, tm.module, TRAIN_RTOL, "two epochs")
    test = _waves(nbatch=1, seed=7)[0]
    want = jm.predict(test)["c_out"].values
    got = tm.predict(_as_port(test))["c_out"]
    assert isinstance(got.data, np.ndarray) and got.dims == (
        "tile", "z", "y", "x")
    assert_close_scaled(got.values, want, PRED_RTOL, "c_out")


def test_registry_and_training_config():
    """Every training function and io name of the JAX package is
    registered in the port (which adds the transformed family), each
    family's hyperparameters with the JAX package's defaults."""
    assert set(tfit.TRAINING_FUNCTIONS) == set(jfit.TRAINING_FUNCTIONS) | {
        "transformed"}
    assert set(tfit._shared._IO_REGISTRY) == set(
        jfit._shared._IO_REGISTRY) | {"transformed"}
    for name in ("reservoir", "fmr", "graph", "autoencoder", "cyclegan",
                 "sklearn_random_forest"):
        assert vars(tfit._shared.get_hyperparameter_class(name)()) == vars(
            jfit._shared.get_hyperparameter_class(name)()), name
        assert tfit.get_training_function(name).__name__ == (
            jfit.get_training_function(name).__name__)
    for name in tfit.TRAINING_FUNCTIONS:
        assert name in jfit.TRAINING_FUNCTIONS
        assert (tfit._shared.get_hyperparameter_class(name) is None) == (
            jfit._shared.get_hyperparameter_class(name) is None)
    assert tfit.get_training_function("dense") is tfit.train_dense_model
    assert (tfit._shared.get_hyperparameter_class("dense")
            is tfit.DenseHyperparameters)
    d = {"model_type": "dense", "hyperparameters": {"depth": 1},
         "input_variables": ["a"], "output_variables": ["b"]}
    want = jfit.TrainingConfig.from_dict(d)
    got = tfit.TrainingConfig.from_dict(d)
    assert vars(got) == vars(want)
    assert vars(tfit.TrainingConfig.from_dict({"model_type": "x"})) == vars(
        jfit.TrainingConfig.from_dict({"model_type": "x"}))
    assert vars(tfit.DenseHyperparameters()) == vars(
        jfit.DenseHyperparameters())
    assert vars(tfit.PrecipitativeHyperparameters()) == vars(
        jfit.PrecipitativeHyperparameters())
    assert vars(tfit.ConvolutionalHyperparameters()) == vars(
        jfit.ConvolutionalHyperparameters())


# --- dumps across the packages ---------------------------------------------

PRECIP_IN = ["air_temperature", "specific_humidity",
             "pressure_thickness_of_atmospheric_layer"]
PRECIP_OUT = ["dQ1", "dQ2", "total_precipitation_rate"]
GSCOND_IN = ("air_temperature_input", "specific_humidity_input",
             "cloud_water_mixing_ratio_input")


def _transformed_hp(pkg, depth):
    import dataclasses

    from fv3net_tpu_torch.fit import transformed as ttr

    cfg = _train_config()
    cfg = dataclasses.replace(
        cfg, epochs=1,
        model=dataclasses.replace(
            cfg.model, architecture=dataclasses.replace(
                cfg.model.architecture, depth=depth, width=4)))
    if pkg == "torch":
        cfg = ttr.TransformedParameters.from_dict(dataclasses.asdict(cfg))
    return cfg


def _family(name, depth, pkg):
    """(train function, hyperparameters, batches, kwargs, prediction
    input) of a family in package `pkg` ("jax" or "torch")."""
    f = jfit if pkg == "jax" else tfit
    wrap = (lambda b: b) if pkg == "jax" else _as_port
    if name == "dense":
        return (f.train_dense_model,
                f.DenseHyperparameters(depth=depth, width=3, epochs=1),
                [wrap(b) for b in _waves()],
                dict(input_variables=IN, output_variables=OUT),
                wrap(_waves(nbatch=1, seed=4)[0]))
    if name == "precipitative":
        return (f.train_precipitative_model,
                f.PrecipitativeHyperparameters(depth=depth, width=3,
                                               epochs=1),
                [wrap(_precip_batch(s)) for s in range(2)],
                dict(input_variables=PRECIP_IN, output_variables=PRECIP_OUT),
                wrap(_precip_batch(5)))
    if name == "convolutional":
        return (f.train_convolutional_model,
                f.ConvolutionalHyperparameters(filters=4, depth=depth,
                                               epochs=1),
                [wrap(_cube_batch(s)) for s in range(2)],
                dict(input_variables=["a_in"], output_variables=["b_out"]),
                wrap(_cube_batch(5)))
    assert name == "transformed"
    batch = _synthetic_gscond_batch(n=256)
    test = _synthetic_gscond_batch(n=64, seed=5)
    Q = JQuantity if pkg == "jax" else TQuantity
    x = {k: Q(test[k], ("sample", "z"), "") for k in GSCOND_IN}
    return (f.train_transformed if pkg == "torch"
            else fv3net_tpu.fit.transformed.train_transformed,
            _transformed_hp(pkg, depth), [batch], {}, x)


FAMILIES = [("dense", 2), ("dense", 11), ("precipitative", 2),
            ("precipitative", 11), ("convolutional", 2),
            ("transformed", 2), ("transformed", 11)]


def _predictions(model, x):
    return {k: np.asarray(q.values) for k, q in model.predict(x).items()}


@pytest.mark.parametrize("name,depth", FAMILIES)
def test_dump_crosses_both_ways(tmp_path, name, depth):
    """A JAX dump loads in the port and predicts the same, the port writes
    it back to the same params.npy bit for bit; a port dump loads in the
    JAX package and predicts the same.  Depth 11 puts Dense_10 before
    Dense_2 (and the named heads among them)."""
    train, hp, batches, kw, x = _family(name, depth, "jax")
    jm = train(hp, batches, **kw)
    jfit.dump(jm, str(tmp_path / "jax"))
    tm = tfit.load(str(tmp_path / "jax"), "cpu")
    assert type(tm).__name__ == type(jm).__name__
    want, got = _predictions(jm, x), _predictions(tm, _as_port(x))
    assert sorted(got) == sorted(want)
    for k in want:
        assert_close_scaled(got[k], want[k], PRED_RTOL, f"jax->port {k}")
    tfit.dump(tm, str(tmp_path / "again"))
    np.testing.assert_array_equal(
        np.load(tmp_path / "again" / "params.npy"),
        np.load(tmp_path / "jax" / "params.npy"))
    assert (tmp_path / "again" / "name").read_text() == name

    train, hp, batches, kw, x = _family(name, depth, "torch")
    tm = train(hp, batches, device="cpu", **kw)
    tfit.dump(tm, str(tmp_path / "port"))
    jm = jfit.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(
        np.load(tmp_path / "port" / "params.npy"), module_to_flat(tm.module))
    want = _predictions(tm, x)
    got = _predictions(jm, {k: JQuantity(np.asarray(q.data), q.dims)
                            for k, q in x.items()})
    for k in want:
        assert_close_scaled(got[k], want[k], PRED_RTOL, f"port->jax {k}")


# --- the train CLI ------------------------------------------------------------


def test_train_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """Both packages' CLIs on the training and data YAML files of
    tests/test_fit.py::test_train_cli (with an override), the port from
    the JAX package's initial parameters: the models predict alike and
    both print the same StepMetadata record."""
    from fv3net_tpu.fit.train import main as jmain
    from fv3net_tpu_torch.fit.train import main as tmain

    tc, dc = tmp_path / "train.yml", tmp_path / "data.yml"
    yaml.safe_dump({
        "model_type": "dense",
        "hyperparameters": {"depth": 1, "width": 8, "epochs": 2},
        "input_variables": ["a"], "output_variables": ["b"],
    }, open(tc, "w"))
    yaml.safe_dump({
        "function": "synthetic_waves",
        "kwargs": {"variables": ["a", "b"], "n": 6, "nz": 3, "nbatch": 2},
    }, open(dc, "w"))
    use_jax_init(monkeypatch, JMLP((8,), 3), (1, 3), 0)
    records = []
    for main, out, extra in ((jmain, "jax", []),
                             (tmain, "port", ["--device", "cpu"])):
        main([str(tc), str(dc), str(tmp_path / out),
              "hyperparameters.epochs=1"] + extra)
        lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
                 if x.startswith("{")]
        meta = lines[0]["step_metadata"]
        records.append((meta["job_type"], meta["dependencies"],
                        lines[-1]["output_path"].endswith(out)))
    assert records[0] == records[1] == ("train", {"training_data": str(dc)},
                                        True)
    jm = jfit.load(str(tmp_path / "jax"))
    tm = tfit.load(str(tmp_path / "port"), "cpu")
    x = SyntheticWaves(["a"], n=6, nz=3, nbatch=1, seed=9).batches()[0]
    assert_close_scaled(tm.predict(_as_port(x))["b"].values,
                        jm.predict(x)["b"].values, PRED_RTOL, "b")
    # and each package loads the other's CLI output
    assert_close_scaled(jfit.load(str(tmp_path / "port")).predict(x)[
        "b"].values, jm.predict(x)["b"].values, PRED_RTOL, "b")


# --- numpy models -------------------------------------------------------------


def _crazy(batch, pkg):
    Q = JQuantity if pkg == "jax" else TQuantity
    return {k: Q(np.asarray(q.data) + 100.0, q.dims) for k, q in
            batch.items()}


def test_min_max_novelty_detector_matches_jax(tmp_path):
    batches = _waves()
    jdet = jfit.train_min_max_novelty_detector(None, batches,
                                               input_variables=IN)
    tdet = tfit.train_min_max_novelty_detector(
        None, [_as_port(b) for b in batches], input_variables=IN)
    np.testing.assert_array_equal(tdet.mins, jdet.mins)
    np.testing.assert_array_equal(tdet.maxes, jdet.maxes)
    test = _waves(nbatch=1, seed=3)[0]
    test[IN[0]] = test[IN[0]].with_data(
        np.asarray(test[IN[0]].data) * 1.5)
    for x, tx in ((test, _as_port(test)),
                  (_crazy(test, "jax"), _crazy(test, "torch"))):
        np.testing.assert_array_equal(tdet.predict_novelty_score(tx),
                                      jdet.predict_novelty_score(x))
        np.testing.assert_array_equal(tdet.predict(tx)["is_novelty"].values,
                                      jdet.predict(x)["is_novelty"].values)
    score = tdet.predict_novelty_score(_as_port(test))
    assert (score > 0).any() and (score <= 0).any()
    tfit.dump(tdet, str(tmp_path / "port"))
    jfit.dump(jdet, str(tmp_path / "jax"))
    np.testing.assert_array_equal(
        jfit.load(str(tmp_path / "port")).predict_novelty_score(test),
        tfit.load(str(tmp_path / "jax"), "cpu").predict_novelty_score(
            _as_port(test)))


def _composites(f, det):
    c1 = f.ConstantOutputPredictor(["a_in"], ["o1"], {"o1": 1.0})
    c2 = f.ConstantOutputPredictor(["a_in"], ["o1"], {"o1": 3.0})
    c3 = f.ConstantOutputPredictor(["a_in"], ["o2"], {"o2": 5.0})
    return {
        "ensemble mean": f.EnsembleModel([c1, c2]),
        "ensemble median": f.EnsembleModel([c1, c2, c1],
                                           reduction="median"),
        "combined": f.CombinedOutputModel([c1, c3]),
        "tapered": f.TaperedModel(c2, cutoff=2, rate=0.5),
        "out of sample": f.OutOfSampleModel(c2, det),
        "derived": f.DerivedModel(c1, ["o1_twice"]),
    }


@pytest.fixture
def derived_twice():
    """One derived output, registered in both packages."""
    for f in (jfit, tfit):
        f.DerivedModel.DERIVED_FUNCTIONS["o1_twice"] = (
            lambda X, out: out["o1"].with_data(2.0 * np.asarray(
                out["o1"].data)))
    yield
    for f in (jfit, tfit):
        del f.DerivedModel.DERIVED_FUNCTIONS["o1_twice"]


def test_composite_models_match_jax(tmp_path, derived_twice):
    """ConstantOutputPredictor and the composite wrappers (ensemble,
    combined, tapered, out of sample, derived) predict as the JAX
    package's, in and out of the detector's envelope, and each package
    loads the other's dump."""
    batches = _waves()
    jdet = jfit.train_min_max_novelty_detector(None, batches,
                                               input_variables=IN)
    tdet = tfit.train_min_max_novelty_detector(
        None, [_as_port(b) for b in batches], input_variables=IN)
    jms = _composites(jfit, jdet)
    tms = _composites(tfit, tdet)
    test = _waves(nbatch=1, seed=3)[0]
    for key in jms:
        for x, tx in ((test, _as_port(test)),
                      (_crazy(test, "jax"), _crazy(test, "torch"))):
            want, got = _predictions(jms[key], x), _predictions(tms[key], tx)
            assert sorted(got) == sorted(want), key
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=key)
        path = str(tmp_path / key.replace(" ", "_"))
        tfit.dump(tms[key], path + "_port")
        jfit.dump(jms[key], path + "_jax")
        for k, v in _predictions(jfit.load(path + "_port"), test).items():
            np.testing.assert_array_equal(
                v, _predictions(tfit.load(path + "_jax", "cpu"),
                                _as_port(test))[k], err_msg=key)
