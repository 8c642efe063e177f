"""Dense-network predictor (the JAX package's ``fit/dense.py``, serving
only).

``DenseModel.load`` reads the directory the JAX package's
``DenseModel.dump`` writes (``meta.json``, ``params.npy``,
``packer_{in,out}.json``, ``scaler_{in,out}.npz``); the flax MLP becomes
an ``nn.Module`` of ``nn.Linear`` layers.  ``train_dense_model`` waits for
the training slice (ROADMAP).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from ..util.quantity import Quantity
from ._shared import ArrayPacker, Predictor, StandardScaler, register


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
        device, a numpy state goes through the packers on the host."""
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
        with torch.no_grad():
            yn = self.module(
                torch.as_tensor(np.asarray(xn, np.float32))
            ).numpy()
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

    @classmethod
    def load(cls, path: str) -> "DenseModel":
        from ..convert import (
            dense_state_dict_from_flax,
            flax_dense_params_from_flat,
        )

        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        module = _MLP(meta["n_in"], meta["widths"], meta["n_out"])
        params = flax_dense_params_from_flat(
            np.load(os.path.join(path, "params.npy")),
            meta["n_in"], meta["widths"], meta["n_out"],
        )
        module.load_state_dict(dense_state_dict_from_flax(params))
        return cls(
            meta["input_variables"],
            meta["output_variables"],
            ArrayPacker.load_from(os.path.join(path, "packer_in.json")),
            ArrayPacker.load_from(os.path.join(path, "packer_out.json")),
            StandardScaler.load_from(os.path.join(path, "scaler_in.npz")),
            StandardScaler.load_from(
                os.path.join(path, "scaler_out.npz")
            ),
            module,
        )
