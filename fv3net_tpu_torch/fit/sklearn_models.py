"""The min/max novelty detector of the JAX package's
``fit/sklearn_models.py`` (_min_max_novelty_detector.py:32; numpy only),
which ``OutOfSampleModel`` uses.  The random forest and the one-class SVM
detector of that module need scikit-learn and are not ported."""

from __future__ import annotations

import json
import os

import numpy as np

from ._shared import (
    ArrayPacker,
    Predictor,
    register,
    register_training_function,
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
