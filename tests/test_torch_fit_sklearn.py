"""The port's scikit-learn models (host code) against the JAX package's:
the random forest and the one-class SVM novelty detector fitted on the
same seeded columns give the same predictions and scores (the same
estimator on the same data and seed), their pickled dumps load in either
package, and without scikit-learn training or loading either one raises
an ImportError naming it.

Tolerance.  The forest's threads add their trees' predictions in no
fixed order: two fits in one package differ by up to 4.4e-16 (measured),
so the forest is held to FOREST_RTOL 1e-12 of the output's magnitude.
The detector's scores are equal bit for bit."""

import sys

import numpy as np
import pytest

from fv3net_tpu import fit as jfit
from fv3net_tpu.data import SyntheticWaves
from fv3net_tpu.fit import sklearn_models as jsk
from fv3net_tpu_torch import fit as tfit
from fv3net_tpu_torch.util.quantity import Quantity as TQuantity
from torch_parity import assert_close_scaled

FOREST_RTOL = 1e-12


def _as_port(batch):
    return {k: TQuantity(np.asarray(q.data), q.dims, q.units)
            for k, q in batch.items()}


def _batches():
    return SyntheticWaves(["a_in", "b_out"], n=6, nz=5, nbatch=3,
                          seed=1).batches()


def _forest(pkg, batches):
    f = jfit if pkg == "jax" else tfit
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return f.train_random_forest(
        f.RandomForestHyperparameters(n_estimators=5, max_depth=4),
        batches, input_variables=["a_in"], output_variables=["b_out"], **kw)


def _detector(pkg, batches):
    f = jsk if pkg == "jax" else tfit
    return f.OCSVMNoveltyDetector(
        ["a_in"], f.ArrayPacker(["a_in"])).fit(batches, nu=0.2)


def test_random_forest_matches_jax(tmp_path):
    """Predictions agree to FOREST_RTOL; dumps load both ways."""
    batches = _batches()
    jm = _forest("jax", batches)
    tm = _forest("torch", [_as_port(b) for b in batches])
    x = _batches()[2]
    want = jm.predict(x)["b_out"]
    got = tm.predict(_as_port(x))["b_out"]
    assert got.dims == want.dims
    assert_close_scaled(got.values, want.values, FOREST_RTOL, "forest")
    jfit.dump(jm, str(tmp_path / "jax"))
    tfit.dump(tm, str(tmp_path / "port"))
    for path, model in (("jax", tfit), ("port", jfit)):
        kw = {"device": "cpu"} if model is tfit else {}
        loaded = model.load(str(tmp_path / path), **kw)
        xin = _as_port(x) if model is tfit else x
        assert_close_scaled(loaded.predict(xin)["b_out"].values,
                            want.values, FOREST_RTOL, f"{path} dump")


def test_ocsvm_detector_matches_jax(tmp_path):
    """Novelty scores and flags equal bit for bit, on the training data and
    on shifted data; dumps load both ways."""
    batches = _batches()
    jd = _detector("jax", batches)
    td = _detector("torch", [_as_port(b) for b in batches])
    x = _batches()[0]
    x["a_in"] = x["a_in"].with_data(np.asarray(x["a_in"].data) + 0.5)
    np.testing.assert_array_equal(td.predict_novelty_score(_as_port(x)),
                                  jd.predict_novelty_score(x))
    flags = td.predict(_as_port(x))["is_novelty"]
    assert flags.dims == ("tile", "y", "x")
    np.testing.assert_array_equal(flags.values,
                                  jd.predict(x)["is_novelty"].values)
    assert 0 < flags.values.sum() < flags.values.size
    jfit.dump(jd, str(tmp_path / "jax"))
    tfit.dump(td, str(tmp_path / "port"))
    np.testing.assert_array_equal(
        tfit.load(str(tmp_path / "jax"), "cpu").predict_novelty_score(
            _as_port(x)), jd.predict_novelty_score(x))
    np.testing.assert_array_equal(
        jfit.load(str(tmp_path / "port")).predict_novelty_score(x),
        jd.predict_novelty_score(x))


def test_without_scikit_learn_raises(tmp_path, monkeypatch):
    """Where scikit-learn cannot be imported, training the forest, fitting
    the detector, and loading either one's dump raise an ImportError that
    names scikit-learn; nothing falls back."""
    batches = [_as_port(b) for b in _batches()]
    tfit.dump(_forest("torch", batches), str(tmp_path / "forest"))
    tfit.dump(_detector("torch", batches), str(tmp_path / "svm"))
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        _forest("torch", batches)
    with pytest.raises(ImportError, match="scikit-learn"):
        _detector("torch", batches)
    for name in ("forest", "svm"):
        with pytest.raises(ImportError, match="scikit-learn"):
            tfit.load(str(tmp_path / name), "cpu")
