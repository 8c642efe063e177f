"""Composite predictors (fv3fit/_shared/models.py equivalents) and test
helpers (fv3fit/testing.py); a copy of the JAX package's
``fit/models.py`` (numpy), whose loaders pass the device on to the models
they hold."""

from __future__ import annotations

import json
import os
from typing import Mapping, Sequence

import numpy as np

from ..util.quantity import Quantity
from ._shared import Predictor, register, load


@register("constant_output")
class ConstantOutputPredictor(Predictor):
    """(fv3fit/testing.py ConstantOutputPredictor)"""

    def __init__(self, input_variables, output_variables,
                 outputs: Mapping[str, float] = None, nz: int = 8):
        super().__init__(input_variables, output_variables)
        self.outputs = dict(outputs or {})
        self.nz = nz

    def predict(self, X):
        ref = X[self.input_variables[0]]
        out = {}
        for name in self.output_variables:
            val = self.outputs.get(name, 0.0)
            out[name] = Quantity(
                np.full(ref.shape, val, np.float32), ref.dims, ""
            )
        return out

    def dump(self, path: str):
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(
                {
                    "input_variables": self.input_variables,
                    "output_variables": self.output_variables,
                    "outputs": self.outputs,
                    "nz": self.nz,
                },
                f,
            )

    @classmethod
    def load(cls, path: str, device):
        with open(os.path.join(path, "config.json")) as f:
            d = json.load(f)
        return cls(d["input_variables"], d["output_variables"],
                   d["outputs"], d["nz"])


@register("derived_model")
class DerivedModel(Predictor):
    """Append derived variables to a base model's outputs
    (models.py:111).  Derived outputs are computed from predictions +
    state by registered functions."""

    DERIVED_FUNCTIONS = {}

    def __init__(self, base_model: Predictor,
                 derived_output_variables: Sequence[str]):
        self.base_model = base_model
        self.derived_output_variables = list(derived_output_variables)
        super().__init__(
            base_model.input_variables,
            list(base_model.output_variables)
            + list(derived_output_variables),
        )

    @classmethod
    def register_derived(cls, name):
        def wrap(fn):
            cls.DERIVED_FUNCTIONS[name] = fn
            return fn

        return wrap

    def predict(self, X):
        out = dict(self.base_model.predict(X))
        for name in self.derived_output_variables:
            out[name] = self.DERIVED_FUNCTIONS[name](X, out)
        return out

    def dump(self, path: str):
        from ._shared import dump as _dump

        _dump(self.base_model, os.path.join(path, "base"))
        with open(os.path.join(path, "derived.json"), "w") as f:
            json.dump(self.derived_output_variables, f)

    @classmethod
    def load(cls, path: str, device):
        base = load(os.path.join(path, "base"), device)
        with open(os.path.join(path, "derived.json")) as f:
            derived = json.load(f)
        return cls(base, derived)


@register("ensemble")
class EnsembleModel(Predictor):
    """Mean/median over member predictions (models.py:224)."""

    def __init__(self, models: Sequence[Predictor],
                 reduction: str = "mean"):
        self.models = list(models)
        self.reduction = reduction
        inputs = sorted(
            {v for m in models for v in m.input_variables}
        )
        outputs = list(models[0].output_variables)
        for m in models[1:]:
            if list(m.output_variables) != outputs:
                raise ValueError(
                    "ensemble members must share output variables"
                )
        super().__init__(inputs, outputs)

    def predict(self, X):
        preds = [m.predict(X) for m in self.models]
        out = {}
        red = np.mean if self.reduction == "mean" else np.median
        for name in self.output_variables:
            stack = np.stack([np.asarray(p[name].data) for p in preds])
            out[name] = preds[0][name].with_data(red(stack, axis=0))
        return out

    def dump(self, path: str):
        from ._shared import dump as _dump

        for i, m in enumerate(self.models):
            _dump(m, os.path.join(path, f"member_{i}"))
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(
                {"n": len(self.models), "reduction": self.reduction}, f
            )

    @classmethod
    def load(cls, path: str, device):
        with open(os.path.join(path, "config.json")) as f:
            d = json.load(f)
        members = [
            load(os.path.join(path, f"member_{i}"), device)
            for i in range(d["n"])
        ]
        return cls(members, d["reduction"])


@register("combined_output")
class CombinedOutputModel(Predictor):
    """Union of disjoint-output models (models.py:20)."""

    def __init__(self, models: Sequence[Predictor]):
        self.models = list(models)
        inputs = sorted({v for m in models for v in m.input_variables})
        outputs = []
        for m in models:
            for v in m.output_variables:
                if v in outputs:
                    raise ValueError(f"duplicate output {v}")
                outputs.append(v)
        super().__init__(inputs, outputs)

    def predict(self, X):
        out = {}
        for m in self.models:
            out.update(m.predict(X))
        return out

    def dump(self, path: str):
        from ._shared import dump as _dump

        for i, m in enumerate(self.models):
            _dump(m, os.path.join(path, f"model_{i}"))
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump({"n": len(self.models)}, f)

    @classmethod
    def load(cls, path: str, device):
        with open(os.path.join(path, "config.json")) as f:
            d = json.load(f)
        return cls(
            [load(os.path.join(path, f"model_{i}"), device)
             for i in range(d["n"])]
        )


@register("tapered")
class TaperedModel(Predictor):
    """Taper predictions to zero above a cutoff level (models.py:66)."""

    def __init__(self, model: Predictor, cutoff: int, rate: float = 5.0):
        self.model = model
        self.cutoff = cutoff
        self.rate = rate
        super().__init__(model.input_variables, model.output_variables)

    def _taper(self, arr):
        nz = arr.shape[1]
        k = np.arange(nz).reshape(1, nz, 1, 1)
        w = 1.0 / (1.0 + np.exp(-(k - self.cutoff) / self.rate))
        return arr * w

    def predict(self, X):
        out = {}
        for name, q in self.model.predict(X).items():
            arr = np.asarray(q.data)
            if arr.ndim == 4:
                arr = self._taper(arr)
            out[name] = q.with_data(arr)
        return out

    def dump(self, path: str):
        from ._shared import dump as _dump

        _dump(self.model, os.path.join(path, "base"))
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump({"cutoff": self.cutoff, "rate": self.rate}, f)

    @classmethod
    def load(cls, path: str, device):
        with open(os.path.join(path, "config.json")) as f:
            d = json.load(f)
        return cls(load(os.path.join(path, "base"), device), d["cutoff"],
                   d["rate"])


@register("out_of_sample")
class OutOfSampleModel(Predictor):
    """Suppress predictions where a novelty detector flags the input
    (models.py:341 + _shared/novelty_detector.py)."""

    def __init__(self, base_model: Predictor, novelty_detector,
                 cutoff: float = 0.0):
        self.base_model = base_model
        self.novelty_detector = novelty_detector
        self.cutoff = cutoff
        super().__init__(
            sorted(
                set(base_model.input_variables)
                | set(novelty_detector.input_variables)
            ),
            base_model.output_variables,
        )

    def predict(self, X):
        out = dict(self.base_model.predict(X))
        score = self.novelty_detector.predict_novelty_score(X)
        is_novel = score > self.cutoff  # [sample]
        for name, q in out.items():
            arr = np.array(q.data)
            if arr.ndim == 4:
                mask = is_novel.reshape(
                    arr.shape[0], arr.shape[2], arr.shape[3]
                )
                arr = np.where(mask[:, None], 0.0, arr)
            out[name] = q.with_data(arr)
        out["is_novelty"] = Quantity(
            is_novel.reshape(
                X[self.base_model.input_variables[0]].shape[0], -1
            ).astype(np.float32),
            ("tile", "sample"),
            "",
        )
        return out

    def dump(self, path: str):
        from ._shared import dump as _dump

        _dump(self.base_model, os.path.join(path, "base"))
        _dump(self.novelty_detector, os.path.join(path, "novelty"))
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump({"cutoff": self.cutoff}, f)

    @classmethod
    def load(cls, path: str, device):
        with open(os.path.join(path, "config.json")) as f:
            d = json.load(f)
        return cls(
            load(os.path.join(path, "base"), device),
            load(os.path.join(path, "novelty"), device),
            d["cutoff"],
        )
