"""The `transformed` training family: microphysics emulators trained in
physics-derived transform spaces.

Re-design of the reference's microphysics-emulation sub-framework
(`external/fv3fit/fv3fit/train_microphysics.py:449-522`
``register_training_function("transformed", TransformedParameters)``,
`fv3fit/emulation/models/_core_model.py` MicrophysicsConfig):

- a ComposedTransform (log cloud, gscond differences, per-temperature-
  bin scaling, Zhao-Carr tendency classes — `emulation/transforms.py`)
  is built from a sample batch and maps physics variables into model
  space;
- a flax MLP with one linear head per output predicts
  ``direct_out_variables`` plus ``residual_out_variables`` (tendency
  added to a base field, MicrophysicsConfig.residual_out_variables);
- the loss is a weighted MSE over transformed variables, normalized by
  per-feature std (fv3fit CustomLoss semantics);
- predictions map back through ``transform.backward`` so the saved
  model speaks physics names and is loadable by
  `emulation.hooks.MicrophysicsHook` inside ``apply_physics``.

The JAX package's ``fit/transformed.py`` for the port: the flax
``_MultiHead`` becomes an ``nn.Module`` (trunk ``Dense_0 .. Dense_{d-1}``,
heads ``Dense_d ..``, as flax numbers them), optax's Adam
``torch.optim.Adam`` (``_shared.adam``); the transforms run on the host in
numpy, the network on the model's device in float32.  The train CLI
reaches this family through the shared TRAINING_FUNCTIONS registry.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from ..emulation.transforms import (
    ComposedTransform,
    ConditionallyScaled,
    compose_from_config,
)
from ..convert import module_from_flat, module_to_flat
from . import _shared
from ._shared import Predictor, register, register_training_function


def _as_flat(batch: Mapping) -> Dict[str, np.ndarray]:
    """State/array dict -> {name: [sample, feature] float32}."""
    out = {}
    for name, v in batch.items():
        arr = np.asarray(getattr(v, "values", v), np.float32)
        if arr.ndim == 1:
            arr = arr[:, None]
        elif arr.ndim == 4:  # [tile, z, y, x] -> [tile*y*x, z]
            arr = np.moveaxis(arr, 1, -1).reshape(-1, arr.shape[1])
        elif arr.ndim == 3:  # [tile, y, x] -> [tile*y*x, 1]
            arr = arr.reshape(-1, 1)
        out[name] = arr
    return out


@dataclasses.dataclass
class ArchitectureConfig:
    """(fv3fit/emulation/layers/architecture.py ArchitectureConfig)"""

    name: str = "dense"  # "dense" | "linear"
    depth: int = 2
    width: int = 256


@dataclasses.dataclass
class MicrophysicsConfig:
    """Model-space wiring (fv3fit MicrophysicsConfig subset)."""

    input_variables: List[str] = dataclasses.field(default_factory=list)
    direct_out_variables: List[str] = dataclasses.field(
        default_factory=list
    )
    # out_name -> base input name; the net predicts a tendency that is
    # added as base + timestep * tendency
    residual_out_variables: Dict[str, str] = dataclasses.field(
        default_factory=dict
    )
    architecture: ArchitectureConfig = dataclasses.field(
        default_factory=ArchitectureConfig
    )
    timestep_seconds: float = 900.0

    @property
    def output_variables(self) -> List[str]:
        return self.direct_out_variables + sorted(
            self.residual_out_variables
        )


@dataclasses.dataclass
class CustomLoss:
    """Weighted normalized-MSE loss spec (fv3fit CustomLoss)."""

    loss_variables: List[str] = dataclasses.field(default_factory=list)
    weights: Dict[str, float] = dataclasses.field(default_factory=dict)
    normalization_floor: float = 1e-12


@dataclasses.dataclass
class TransformedParameters:
    """(train_microphysics.py:121 TransformedParameters subset)"""

    tensor_transform: List[dict] = dataclasses.field(default_factory=list)
    model: MicrophysicsConfig = dataclasses.field(
        default_factory=MicrophysicsConfig
    )
    loss: CustomLoss = dataclasses.field(default_factory=CustomLoss)
    epochs: int = 10
    batch_size: int = 512
    learning_rate: float = 1e-3
    seed: int = 0

    @classmethod
    def from_dict(cls, d: Mapping) -> "TransformedParameters":
        d = dict(d)
        if "model" in d and isinstance(d["model"], Mapping):
            m = dict(d["model"])
            if isinstance(m.get("architecture"), Mapping):
                m["architecture"] = ArchitectureConfig(**m["architecture"])
            d["model"] = MicrophysicsConfig(**m)
        if "loss" in d and isinstance(d["loss"], Mapping):
            d["loss"] = CustomLoss(**d["loss"])
        return cls(**d)


class _MultiHead(nn.Module):
    """Shared trunk + one linear head per output, widths per output."""

    def __init__(self, n_in: int, trunk_widths: Sequence[int],
                 head_widths: Sequence[int]):
        super().__init__()
        self.trunk_widths = tuple(trunk_widths)
        self.head_widths = tuple(head_widths)  # feature width of each output
        sizes = [n_in] + list(trunk_widths)
        self.trunk = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:])
        )
        self.heads = nn.ModuleList(
            nn.Linear(sizes[-1], w) for w in head_widths
        )

    def forward(self, x):
        for layer in self.trunk:
            x = torch.relu(layer(x))
        return [head(x) for head in self.heads]

    def flax_layers(self):
        layers = list(self.trunk) + list(self.heads)
        return {f"Dense_{i}": m for i, m in enumerate(layers)}


def _fitted_transform_params(transform: ComposedTransform):
    out = {}
    for i, t in enumerate(transform.transforms):
        if isinstance(t, ConditionallyScaled):
            for k, v in t.params().items():
                out[f"t{i}_{k}"] = v
    return out


def _restore_transform(specs, fitted: Mapping) -> ComposedTransform:
    base = compose_from_config(specs)
    restored = []
    for i, t in enumerate(base.transforms):
        if isinstance(t, ConditionallyScaled):
            t = t.with_params(
                fitted[f"t{i}_edges"], fitted[f"t{i}_mean"],
                fitted[f"t{i}_std"],
            )
        restored.append(t)
    return ComposedTransform(restored)


@register("transformed")
class TransformedPredictor(Predictor):
    """Physics-space predictor around a model-space network."""

    def __init__(self, config: TransformedParameters,
                 transform: ComposedTransform, module: _MultiHead,
                 norms: Dict[str, np.ndarray]):
        self.config = config
        self.transform = transform
        self.module = module.float().eval()
        self.norms = norms  # per-variable (mean, std) in model space
        model = config.model
        # the hook feeds physics names; advertise what must be present
        needed = sorted(
            transform.forward_input_names(set(model.input_variables))
        )
        super().__init__(needed, self._physics_outputs(needed))

    def _physics_outputs(self, inputs):
        """Physics names prediction reconstructs: round-trip a dummy
        input dict through forward, graft the model outputs on, run
        backward, and keep every new name the backward pass added."""
        model = self.config.model
        dummy = {
            name: np.full((2, self._in_width(name)), 0.5, np.float32)
            for name in inputs
        }
        fwd = self.transform.forward(dict(dummy))
        y = dict(fwd)
        for name, w in zip(model.output_variables, self._head_widths()):
            y[name] = np.full((2, max(w, 1)), 0.5, np.float32)
        back = self.transform.backward(y)
        transform_tos = {
            getattr(t, "to", None) for t in self.transform.transforms
        }
        out = {
            n for n in back
            if n not in fwd
            and getattr(back[n], "dtype", np.dtype(np.float32)).kind
            != "b"
        }
        # direct physics-name outputs pass through untransformed
        out |= {
            n for n in model.direct_out_variables
            if n not in transform_tos
        }
        out -= set(model.output_variables) & transform_tos
        return sorted(out)

    def _head_widths(self):
        return [self.norms[n + "_std"].shape[-1]
                for n in self.config.model.output_variables]

    def _in_width(self, name):
        key = name + "_std"
        if key in self.norms:
            return self.norms[key].shape[-1]
        return 1

    def predict(self, X):
        flat = _as_flat(X)
        x = self.transform.forward(flat)
        model = self.config.model
        cols = []
        for name in model.input_variables:
            mean = self.norms[name + "_mean"]
            std = self.norms[name + "_std"]
            cols.append((x[name] - mean) / std)
        xin = np.concatenate(cols, axis=-1).astype(np.float32)
        heads = _shared.run_on_device(self.module, xin)
        y = dict(x)
        for name, h in zip(model.output_variables, heads):
            mean = self.norms[name + "_mean"]
            std = self.norms[name + "_std"]
            h = h * std + mean
            if name in model.residual_out_variables:
                base = x[model.residual_out_variables[name]]
                h = base + model.timestep_seconds * h
            y[name] = h
        phys = self.transform.backward(y)
        out = {}
        ref = next(iter(X.values()))
        for name in self.output_variables:
            arr = phys[name]
            out[name] = self._unflatten(arr, ref)
        return out

    def _unflatten(self, arr, ref: "Quantity"):
        from ..util.quantity import Quantity

        rshape = ref.shape
        if len(rshape) == 4:  # [tile, z, y, x]
            t, z, yy, xx = rshape
            a = arr.reshape(t, yy, xx, -1)
            if a.shape[-1] == 1:
                return Quantity(a[..., 0], ("tile", "y", "x"), "")
            return Quantity(
                np.moveaxis(a, -1, 1), ("tile", "z", "y", "x"), ""
            )
        if arr.ndim == 2 and arr.shape[-1] == 1 and len(rshape) == 1:
            return Quantity(arr[:, 0], ref.dims, "")
        return Quantity(arr, ("sample", "z")[: arr.ndim], "")

    def dump(self, path: str):
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "params.npy"), module_to_flat(self.module))
        np.savez(os.path.join(path, "norms.npz"), **self.norms)
        np.savez(
            os.path.join(path, "transform_fitted.npz"),
            **_fitted_transform_params(self.transform),
        )
        cfg = dataclasses.asdict(self.config)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(cfg, f)

    @classmethod
    def load(cls, path: str, device) -> "TransformedPredictor":
        with open(os.path.join(path, "config.json")) as f:
            cfg = TransformedParameters.from_dict(json.load(f))
        norms = dict(np.load(os.path.join(path, "norms.npz")))
        fitted = dict(
            np.load(os.path.join(path, "transform_fitted.npz"))
        )
        transform = _restore_transform(cfg.tensor_transform, fitted)
        head_widths = [
            norms[n + "_std"].shape[-1]
            for n in cfg.model.output_variables
        ]
        arch = cfg.model.architecture
        trunk = (
            (arch.width,) * arch.depth if arch.name == "dense" else ()
        )
        n_in = sum(
            norms[n + "_std"].shape[-1]
            for n in cfg.model.input_variables
        )
        module = _MultiHead(n_in, trunk, tuple(head_widths))
        module_from_flat(module, np.load(os.path.join(path, "params.npy")))
        return cls(cfg, transform, module.to(device), norms)


@register_training_function("transformed", TransformedParameters)
def train_transformed(
    hyperparameters: TransformedParameters,
    train_batches,
    validation_batches=None,
    input_variables=None,
    output_variables=None,
    device=None,
) -> TransformedPredictor:
    """Train a transformed-space microphysics emulator, the network in
    float32 on `device` (the CUDA device unless the caller names one).

    train_batches: iterable of dicts name -> array [sample(, feature)]
    (or Quantity dicts, incl. [tile, z, y, x] fields which are stacked
    to columns).
    """
    hp = hyperparameters
    device = _shared.train_device(device, "train_transformed")
    model = hp.model
    batches = [_as_flat(b) for b in train_batches]
    sample = {
        k: np.concatenate([b[k] for b in batches])
        for k in batches[0]
    }
    transform = compose_from_config(hp.tensor_transform).build(sample)
    ts = transform.forward(sample)

    norms: Dict[str, np.ndarray] = {}
    floor = hp.loss.normalization_floor
    for name in set(model.input_variables) | set(model.output_variables):
        arr = np.asarray(ts[name] if name in ts else sample[name])
        target = arr
        if name in model.residual_out_variables:
            base = ts[model.residual_out_variables[name]]
            target = (arr - base) / model.timestep_seconds
        norms[name + "_mean"] = target.mean(0, keepdims=True).astype(
            np.float32
        )
        norms[name + "_std"] = np.maximum(
            target.std(0, keepdims=True), floor
        ).astype(np.float32)

    xin = np.concatenate(
        [
            (ts[n] - norms[n + "_mean"]) / norms[n + "_std"]
            for n in model.input_variables
        ],
        axis=-1,
    ).astype(np.float32)
    targets = []
    for n in model.output_variables:
        t = ts[n]
        if n in model.residual_out_variables:
            t = (
                t - ts[model.residual_out_variables[n]]
            ) / model.timestep_seconds
        targets.append(
            ((t - norms[n + "_mean"]) / norms[n + "_std"]).astype(
                np.float32
            )
        )

    loss_names = hp.loss.loss_variables or model.output_variables
    weights = torch.as_tensor(
        [
            hp.loss.weights.get(n, 1.0) if n in loss_names else 0.0
            for n in model.output_variables
        ],
        dtype=torch.float32, device=device,
    )

    arch = model.architecture
    trunk = (arch.width,) * arch.depth if arch.name == "dense" else ()
    module = _MultiHead(
        xin.shape[1], trunk, tuple(t.shape[-1] for t in targets)
    )
    _shared.init_params(module, hp.seed)
    module.to(device)
    optimizer = _shared.adam(module, hp.learning_rate)

    def loss_fn(module, xb, *ybs):
        preds = module(xb)
        losses = torch.stack(
            [torch.mean((pr - yb) ** 2) for pr, yb in zip(preds, ybs)]
        )
        return torch.sum(weights * losses)

    _shared.fit_epochs(
        module, optimizer, loss_fn,
        [torch.as_tensor(xin, device=device)]
        + [torch.as_tensor(t, device=device) for t in targets],
        hp.batch_size, hp.epochs, hp.seed,
    )
    return TransformedPredictor(hp, transform, module, norms)
