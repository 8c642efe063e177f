"""The scikit-learn models and the novelty detectors of the JAX
package's ``fit/sklearn_models.py`` (fv3fit sklearn/_random_forest.py:39,
_min_max_novelty_detector.py:32, _ocsvm_novelty_detector.py:36), copied
as host code: the random forest and the one-class SVM are scikit-learn
estimators, fitted and evaluated on the host, and pickled as they are, so
a dump from either package loads in the other.  scikit-learn is imported
only where one of them is trained or loaded; without it, that raises an
``ImportError`` naming scikit-learn (the GPU machine has none).  The
min/max detector is numpy only.  The ``device`` of the training functions
is unused: they run on the host.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle

import numpy as np

from ._shared import (
    ArrayPacker,
    Predictor,
    StandardScaler,
    register,
    register_training_function,
)


def _require_sklearn(what: str):
    """Import scikit-learn for `what`, or raise an ImportError naming it."""
    try:
        import sklearn  # noqa: F401
    except ImportError as err:
        raise ImportError(
            f"{what} needs scikit-learn, which is not installed"
        ) from err


def _unpickle(path: str, what: str):
    _require_sklearn(what)
    with open(path, "rb") as f:
        return pickle.load(f)


@dataclasses.dataclass
class RandomForestHyperparameters:
    n_estimators: int = 10
    max_depth: int = 10
    seed: int = 0


@register("sklearn_random_forest")
class RandomForestModel(Predictor):
    def __init__(self, input_variables, output_variables, packer_in,
                 packer_out, regressor):
        super().__init__(input_variables, output_variables)
        self.packer_in = packer_in
        self.packer_out = packer_out
        self.regressor = regressor

    def predict(self, X):
        from .dense import DenseModel

        x = self.packer_in.to_array(X)
        y = self.regressor.predict(x)
        if y.ndim == 1:
            y = y[:, None]
        templates = DenseModel._templates(self, X)
        return self.packer_out.to_state(y, templates)

    def dump(self, path: str):
        self.packer_in.dump(os.path.join(path, "packer_in.json"))
        self.packer_out.dump(os.path.join(path, "packer_out.json"))
        with open(os.path.join(path, "model.pkl"), "wb") as f:
            pickle.dump(self.regressor, f)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(
                {
                    "input_variables": self.input_variables,
                    "output_variables": self.output_variables,
                },
                f,
            )

    @classmethod
    def load(cls, path: str, device):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        reg = _unpickle(os.path.join(path, "model.pkl"),
                        "loading a random forest")
        return cls(
            meta["input_variables"],
            meta["output_variables"],
            ArrayPacker.load_from(os.path.join(path, "packer_in.json")),
            ArrayPacker.load_from(os.path.join(path, "packer_out.json")),
            reg,
        )


@register_training_function(
    "sklearn_random_forest", RandomForestHyperparameters
)
def train_random_forest(
    hyperparameters: RandomForestHyperparameters,
    train_batches,
    validation_batches=None,
    input_variables=None,
    output_variables=None,
    device=None,
):
    """scikit-learn's RandomForestRegressor on the stacked columns (host
    code: `device` is unused)."""
    _require_sklearn("train_random_forest")
    from sklearn.ensemble import RandomForestRegressor

    hp = hyperparameters
    batches = list(train_batches)
    packer_in = ArrayPacker(list(input_variables))
    packer_out = ArrayPacker(list(output_variables))
    X = np.concatenate([packer_in.to_array(b) for b in batches])
    Y = np.concatenate([packer_out.to_array(b) for b in batches])
    reg = RandomForestRegressor(
        n_estimators=hp.n_estimators,
        max_depth=hp.max_depth,
        random_state=hp.seed,
        n_jobs=-1,
    )
    reg.fit(X, Y)
    return RandomForestModel(
        list(input_variables), list(output_variables), packer_in,
        packer_out, reg,
    )


@register("min_max_novelty_detector")
class MinMaxNoveltyDetector(Predictor):
    """Flag inputs outside the training min/max envelope
    (_min_max_novelty_detector.py:32)."""

    def __init__(self, input_variables, packer, mins=None, maxes=None):
        super().__init__(input_variables, ["is_novelty"])
        self.packer = packer
        self.mins = mins
        self.maxes = maxes

    def fit(self, batches):
        X = np.concatenate(
            [self.packer.to_array(b) for b in batches]
        )
        self.mins = X.min(axis=0)
        self.maxes = X.max(axis=0)
        return self

    def predict_novelty_score(self, X) -> np.ndarray:
        x = self.packer.to_array(X)
        below = np.maximum(self.mins - x, 0.0)
        above = np.maximum(x - self.maxes, 0.0)
        return (below + above).max(axis=1)

    def predict(self, X):
        from ..util.quantity import Quantity

        score = self.predict_novelty_score(X)
        ref = X[self.input_variables[0]]
        is_novel = (score > 0).astype(np.float32)
        if len(ref.shape) == 4:
            arr = is_novel.reshape(ref.shape[0], ref.shape[2],
                                   ref.shape[3])
            dims = ("tile", "y", "x")
        else:
            arr = is_novel
            dims = ("sample",)
        return {"is_novelty": Quantity(arr, dims, "")}

    def dump(self, path: str):
        self.packer.dump(os.path.join(path, "packer.json"))
        np.savez(os.path.join(path, "bounds.npz"), mins=self.mins,
                 maxes=self.maxes)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"input_variables": self.input_variables}, f)

    @classmethod
    def load(cls, path: str, device):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        b = np.load(os.path.join(path, "bounds.npz"))
        return cls(
            meta["input_variables"],
            ArrayPacker.load_from(os.path.join(path, "packer.json")),
            b["mins"],
            b["maxes"],
        )


@register_training_function("min_max_novelty_detector", None)
def train_min_max_novelty_detector(
    hyperparameters, train_batches, validation_batches=None,
    input_variables=None, output_variables=None, device=None,
):
    """The envelope of the training inputs (numpy: `device` is unused)."""
    det = MinMaxNoveltyDetector(
        list(input_variables), ArrayPacker(list(input_variables))
    )
    return det.fit(list(train_batches))


@register("ocsvm_novelty_detector")
class OCSVMNoveltyDetector(Predictor):
    """One-class SVM novelty detector (_ocsvm_novelty_detector.py:36)."""

    def __init__(self, input_variables, packer, scaler=None, svm=None):
        super().__init__(input_variables, ["is_novelty"])
        self.packer = packer
        self.scaler = scaler
        self.svm = svm

    def fit(self, batches, nu=0.1, gamma="scale"):
        _require_sklearn("OCSVMNoveltyDetector.fit")
        from sklearn.svm import OneClassSVM

        X = np.concatenate([self.packer.to_array(b) for b in batches])
        self.scaler = StandardScaler().fit(X)
        self.svm = OneClassSVM(nu=nu, gamma=gamma)
        self.svm.fit(self.scaler.normalize(X))
        return self

    def predict_novelty_score(self, X) -> np.ndarray:
        x = self.scaler.normalize(self.packer.to_array(X))
        return -self.svm.decision_function(x)

    def predict(self, X):
        from ..util.quantity import Quantity

        score = self.predict_novelty_score(X)
        ref = X[self.input_variables[0]]
        is_novel = (score > 0).astype(np.float32)
        arr = is_novel.reshape(ref.shape[0], ref.shape[2], ref.shape[3])
        return {
            "is_novelty": Quantity(arr, ("tile", "y", "x"), "")
        }

    def dump(self, path: str):
        self.packer.dump(os.path.join(path, "packer.json"))
        self.scaler.dump(os.path.join(path, "scaler.npz"))
        with open(os.path.join(path, "svm.pkl"), "wb") as f:
            pickle.dump(self.svm, f)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"input_variables": self.input_variables}, f)

    @classmethod
    def load(cls, path: str, device):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        svm = _unpickle(os.path.join(path, "svm.pkl"),
                        "loading a one-class SVM detector")
        return cls(
            meta["input_variables"],
            ArrayPacker.load_from(os.path.join(path, "packer.json")),
            StandardScaler.load_from(os.path.join(path, "scaler.npz")),
            svm,
        )
