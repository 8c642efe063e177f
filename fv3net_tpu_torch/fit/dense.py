"""Dense-network trainer and predictor (the JAX package's ``fit/dense.py``,
the ``dense`` training function; fv3fit/keras/_models/dense.py:90).

The flax MLP becomes an ``nn.Module`` of ``nn.Linear`` layers (flax
``Dense_i`` is ``layers[i]``), optax's Adam ``torch.optim.Adam``
(``_shared.adam``).  ``DenseModel.dump`` writes, and ``DenseModel.load``
reads, the JAX package's directory (``meta.json``, ``params.npy``,
``packer_{in,out}.json``, ``scaler_{in,out}.npz``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from ..convert import module_from_flat, module_to_flat
from ..util.quantity import Quantity
from . import _shared
from ._shared import (
    ArrayPacker,
    Predictor,
    StandardScaler,
    register,
    register_training_function,
)


@dataclasses.dataclass
class DenseHyperparameters:
    """(fv3fit DenseHyperparameters subset)"""

    depth: int = 3
    width: int = 64
    epochs: int = 20
    batch_size: int = 512
    learning_rate: float = 1e-3
    seed: int = 0


class _MLP(nn.Module):
    """ReLU MLP: Linear -> relu for each hidden width, then a Linear to
    n_out (flax ``Dense_i`` is ``layers[i]``)."""

    def __init__(self, n_in: int, widths: Sequence[int], n_out: int):
        super().__init__()
        self.widths = tuple(widths)
        self.n_out = n_out
        sizes = [n_in] + list(widths) + [n_out]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:])
        )

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)

    def flax_layers(self):
        return {f"Dense_{i}": m for i, m in enumerate(self.layers)}


@register("dense")
class DenseModel(Predictor):
    def __init__(self, input_variables, output_variables, packer_in,
                 packer_out, scaler_in, scaler_out, module: _MLP):
        super().__init__(input_variables, output_variables)
        self.packer_in = packer_in
        self.packer_out = packer_out
        self.scaler_in = scaler_in
        self.scaler_out = scaler_out
        self.module = module.float().eval()
        self.params = dict(self.module.state_dict())
        self._scaler_cache = {}

    def params_on(self, device) -> Dict[str, torch.Tensor]:
        """The float32 parameters on `device` (for ``pure_fn``)."""
        return {k: v.to(device) for k, v in self.params.items()}

    def _scaler_tensors(self, which, device, dtype):
        """(mean, std) of scaler_in/scaler_out as tensors, staged to the
        device once per (device, dtype)."""
        key = (which, device, dtype)
        if key not in self._scaler_cache:
            s = self.scaler_in if which == "in" else self.scaler_out
            self._scaler_cache[key] = tuple(
                torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
                for v in (s.mean, s.std)
            )
        return self._scaler_cache[key]

    def pure_fn(self, params, arrs):
        """pack -> normalize -> MLP -> denormalize -> unpack as a function
        of (params, {name: tensor}) -> {name: tensor}, as the JAX
        package's ``pure_fn``: the inputs are normalized in the state's
        dtype, the MLP runs in float32 and the outputs are denormalized in
        float32 (whatever the state's dtype)."""
        blocks = [
            a.reshape(-1, 1) if a.ndim == 3
            else torch.movedim(a, 1, -1).reshape(-1, a.shape[1])
            if a.ndim == 4 else a
            for a in (arrs[name] for name in self.input_variables)
        ]
        x = torch.cat(blocks, dim=1)
        mean_in, std_in = self._scaler_tensors("in", x.device, x.dtype)
        mean_out, std_out = self._scaler_tensors(
            "out", x.device, torch.float32
        )
        with torch.no_grad():
            yn = torch.func.functional_call(
                self.module, params, (((x - mean_in) / std_in).float(),)
            )
        y = yn * std_out + mean_out
        out = {}
        i = 0
        ref = arrs[self.input_variables[0]]
        for name in self.output_variables:
            w = self.packer_out._feature_counts[name]
            block = y[:, i : i + w]
            i += w
            if ref.ndim == 4 and w > 1:
                t, _, yy, xx = ref.shape
                out[name] = torch.movedim(block.reshape(t, yy, xx, w), -1, 1)
            elif ref.ndim == 4:
                t, _, yy, xx = ref.shape
                out[name] = block.reshape(t, yy, xx)
            else:
                out[name] = block
        return out

    def predict(self, X):
        """Predict from a State; a tensor state runs ``pure_fn`` on its
        device, a numpy state goes through the packers and host scalers,
        the MLP on the model's device, and comes back as numpy."""
        ref = X[self.input_variables[0]]
        if isinstance(ref.data, torch.Tensor):
            outs = self.pure_fn(
                self.params_on(ref.data.device),
                {k: X[k].data for k in self.input_variables},
            )
            templates = self._templates(X)
            return {k: templates[k].with_data(v) for k, v in outs.items()}
        x = self.packer_in.to_array(X)
        xn = self.scaler_in.normalize(x)
        yn = _shared.run_on_device(self.module, xn)
        y = self.scaler_out.denormalize(yn)
        return self.packer_out.to_state(y, self._templates(X))

    def _templates(self, X):
        ref = X[self.input_variables[0]]
        out = {}
        for name in self.output_variables:
            width = self.packer_out._feature_counts[name]
            if len(ref.shape) == 4 and width > 1:
                shape = (ref.shape[0], width, ref.shape[2], ref.shape[3])
                dims = ("tile", "z", "y", "x")
            elif len(ref.shape) == 4:
                shape = (ref.shape[0], ref.shape[2], ref.shape[3])
                dims = ("tile", "y", "x")
            else:
                shape = ref.shape
                dims = ref.dims
            out[name] = Quantity(np.zeros(shape, np.float32), dims, "")
        return out

    def dump(self, path: str):
        self.packer_in.dump(os.path.join(path, "packer_in.json"))
        self.packer_out.dump(os.path.join(path, "packer_out.json"))
        self.scaler_in.dump(os.path.join(path, "scaler_in.npz"))
        self.scaler_out.dump(os.path.join(path, "scaler_out.npz"))
        np.save(os.path.join(path, "params.npy"), module_to_flat(self.module))
        meta = {
            "input_variables": self.input_variables,
            "output_variables": self.output_variables,
            "widths": list(self.module.widths),
            "n_out": self.module.n_out,
            "n_in": int(self.scaler_in.mean.shape[0]),
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, device) -> "DenseModel":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        module = _MLP(meta["n_in"], meta["widths"], meta["n_out"])
        module_from_flat(module, np.load(os.path.join(path, "params.npy")))
        return cls(
            meta["input_variables"],
            meta["output_variables"],
            ArrayPacker.load_from(os.path.join(path, "packer_in.json")),
            ArrayPacker.load_from(os.path.join(path, "packer_out.json")),
            StandardScaler.load_from(os.path.join(path, "scaler_in.npz")),
            StandardScaler.load_from(
                os.path.join(path, "scaler_out.npz")
            ),
            module.to(device),
        )


def _mse(module, xb, yb):
    return torch.mean((module(xb) - yb) ** 2)


@register_training_function("dense", DenseHyperparameters)
def train_dense_model(
    hyperparameters: DenseHyperparameters,
    train_batches,
    validation_batches=None,
    input_variables=None,
    output_variables=None,
    device=None,
) -> DenseModel:
    """Train an MLP mapping stacked input columns to output columns, in
    float32 on `device` (the CUDA device unless the caller names one).

    train_batches: iterable of State dicts (each a batch).
    """
    hp = hyperparameters
    device = _shared.train_device(device, "train_dense_model")
    batches = list(train_batches)
    packer_in = ArrayPacker(list(input_variables))
    packer_out = ArrayPacker(list(output_variables))
    X = np.concatenate([packer_in.to_array(b) for b in batches])
    Y = np.concatenate([packer_out.to_array(b) for b in batches])
    scaler_in = StandardScaler().fit(X)
    scaler_out = StandardScaler().fit(Y)
    Xn = scaler_in.normalize(X).astype(np.float32)
    Yn = scaler_out.normalize(Y).astype(np.float32)

    module = _MLP(X.shape[1], (hp.width,) * hp.depth, Y.shape[1])
    _shared.init_params(module, hp.seed)
    module.to(device)
    optimizer = _shared.adam(module, hp.learning_rate)
    _shared.fit_epochs(
        module, optimizer, _mse,
        (torch.as_tensor(Xn, device=device),
         torch.as_tensor(Yn, device=device)),
        hp.batch_size, hp.epochs, hp.seed,
    )
    return DenseModel(
        list(input_variables), list(output_variables), packer_in,
        packer_out, scaler_in, scaler_out, module,
    )
