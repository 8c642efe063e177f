"""Convolutional trainer on the cubed sphere (the `convolutional`
training function, fv3fit/keras/_models/convolutional.py:101).

The reference appends cube-topology halos to each tile with
pace.util DummyComm machinery (fv3fit/keras/_models/shared/
halos.py:10-60) and runs a keras CNN with VALID padding so the output
is exactly the interior.  Here the halo append IS the port's
halo_exchange gather (grid/halo.py) -- the same edge/corner rotation
semantics as the JAX package's -- and the CNN is an ``nn.Module`` of
``nn.Conv2d`` layers (flax ``Conv_i`` is ``convs[i]``, the 1x1 head
``Conv_{depth}``), run in NCHW on the model's device; the fields stay
channel-last [6, y, x, c] outside it, as in the JAX package.  The
loss's gradient flows back through the exchange's gather (autograd's
scatter-add).

Fields are packed [6, y, x, channels] with z as channels (the
reference stacks [tile, x, y, z] the same way, convolutional.py:92).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os

import numpy as np
import torch
from torch import nn

from ..convert import module_from_flat, module_to_flat
from ..graphs import jit
from . import _shared
from ._shared import (
    Predictor,
    StandardScaler,
    register,
    register_training_function,
)
from ..grid.halo import halo_exchange


@dataclasses.dataclass
class ConvolutionalHyperparameters:
    """(fv3fit ConvolutionalHyperparameters subset)"""

    filters: int = 32
    depth: int = 2  # conv layers; receptive radius = depth*(kernel//2)
    kernel_size: int = 3
    epochs: int = 10
    learning_rate: float = 1e-3
    seed: int = 0


class _CNN(nn.Module):
    def __init__(self, n_in: int, filters: int, depth: int, kernel: int,
                 n_out: int):
        super().__init__()
        self.filters = filters
        self.depth = depth
        self.kernel = kernel
        self.n_out = n_out
        chans = [n_in] + [filters] * depth
        self.convs = nn.ModuleList(
            nn.Conv2d(a, b, kernel) for a, b in zip(chans[:-1], chans[1:])
        )
        self.head = nn.Conv2d(chans[-1], n_out, 1)

    def forward(self, x):  # [batch, y+2h, x+2h, c]
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = torch.relu(conv(x))  # VALID padding
        return self.head(x).permute(0, 2, 3, 1)

    def flax_layers(self):
        layers = {f"Conv_{i}": m for i, m in enumerate(self.convs)}
        layers[f"Conv_{self.depth}"] = self.head
        return layers


def _halo_radius(hp: ConvolutionalHyperparameters) -> int:
    return hp.depth * (hp.kernel_size // 2)


def _stack_channels(state, names):
    """[6, z, y, x] fields -> [6, y, x, sum(z)]; 2D fields add one
    channel.  Returns (array, per-name widths); width 0 marks a 2D
    [6, y, x] field (so a z=1 3D field stays distinguishable)."""
    blocks, widths = [], {}
    for name in names:
        arr = np.asarray(state[name].values, np.float32)
        if arr.ndim == 4:
            blocks.append(np.moveaxis(arr, 1, -1))
            widths[name] = arr.shape[1]
        elif arr.ndim == 3:
            blocks.append(arr[..., None])
            widths[name] = 0
        else:
            raise ValueError(f"bad rank for {name}: {arr.shape}")
    return np.concatenate(blocks, axis=-1), widths


def _num_channels(widths) -> int:
    return int(sum(max(w, 1) for w in widths.values()))


def _unstack_channels(y, names, widths):
    """Inverse of _stack_channels: [..., y, x, c] -> Quantity dict."""
    from ..util.quantity import Quantity

    out, i = {}, 0
    for name in names:
        w = widths[name]
        wc = max(w, 1)
        block = y[..., i : i + wc]
        i += wc
        if w == 0:
            out[name] = Quantity(block[..., 0], ("tile", "y", "x"), "")
        else:
            out[name] = Quantity(
                np.moveaxis(block, -1, 1), ("tile", "z", "y", "x"), ""
            )
    return out


class _ChannelScaler(StandardScaler):
    """Mean and std per channel (the last axis) over every other axis."""

    def fit(self, A):
        axes = tuple(range(A.ndim - 1))
        self.mean = A.mean(axis=axes)
        self.std = A.std(axis=axes) + self.std_epsilon
        return self


def append_halos(tilewise: torch.Tensor, n_halo: int) -> torch.Tensor:
    """Cube-topology halo append for [6, y, x, c] channel-last data
    (the fv3fit append_halos contract, halos.py:10)."""
    moved = torch.movedim(tilewise, -1, 1)  # [6, c, y, x]
    padded = halo_exchange(moved, n_halo)
    return torch.movedim(padded, 1, -1)


def _forward(module, x, n_halo):
    xh = append_halos(x, n_halo) if n_halo else x
    return module(xh)


@contextlib.contextmanager
def _float32_convolutions():
    """cuDNN's convolutions in IEEE float32 instead of torch's default
    TF32 on the card, as the JAX package's float32 training computes
    them; restored on exit."""
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = allow


@register("convolutional")
class ConvolutionalModel(Predictor):
    def __init__(self, input_variables, output_variables, widths_in,
                 widths_out, scaler_in, scaler_out, module, n_halo):
        super().__init__(input_variables, output_variables)
        self.widths_in = widths_in
        self.widths_out = widths_out
        self.scaler_in = scaler_in
        self.scaler_out = scaler_out
        self.module = module.float().eval()
        self.n_halo = n_halo
        # the JAX package's jitted apply (halos appended inside)
        self._apply = jit(_shared.no_grad(self._forward_with_halos,
                                          _float32_convolutions))

    def _forward_with_halos(self, x):
        return _forward(self.module, x, self.n_halo)

    def predict(self, X):
        x, _ = _stack_channels(X, self.input_variables)
        xn = (x - self.scaler_in.mean) / self.scaler_in.std
        yn = _shared.run_on_device(self.module, xn, self._apply)
        y = yn * self.scaler_out.std + self.scaler_out.mean
        return _unstack_channels(
            y, self.output_variables, self.widths_out
        )

    def dump(self, path: str):
        self.scaler_in.dump(os.path.join(path, "scaler_in.npz"))
        self.scaler_out.dump(os.path.join(path, "scaler_out.npz"))
        np.save(os.path.join(path, "params.npy"), module_to_flat(self.module))
        meta = {
            "input_variables": self.input_variables,
            "output_variables": self.output_variables,
            "widths_in": self.widths_in,
            "widths_out": self.widths_out,
            "filters": self.module.filters,
            "depth": self.module.depth,
            "kernel": self.module.kernel,
            "n_out": self.module.n_out,
            "n_halo": self.n_halo,
            "n_in": _num_channels(self.widths_in),
            # v2: width 0 marks a 2D [6, y, x] field (v1 used width 1,
            # which collides with a z=1 3D field)
            "format_version": 2,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, device) -> "ConvolutionalModel":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("format_version", 1) < 2:
            # v1 checkpoints marked 2D fields with width 1; translate so
            # predict() returns ("tile","y","x") for them as before
            meta["widths_in"] = {
                k: 0 if w == 1 else w
                for k, w in meta["widths_in"].items()
            }
            meta["widths_out"] = {
                k: 0 if w == 1 else w
                for k, w in meta["widths_out"].items()
            }
        module = _CNN(meta["n_in"], meta["filters"], meta["depth"],
                      meta["kernel"], meta["n_out"])
        module_from_flat(module, np.load(os.path.join(path, "params.npy")))
        scaler_in = StandardScaler.load_from(
            os.path.join(path, "scaler_in.npz")
        )
        scaler_out = StandardScaler.load_from(
            os.path.join(path, "scaler_out.npz")
        )
        return cls(
            meta["input_variables"], meta["output_variables"],
            meta["widths_in"], meta["widths_out"], scaler_in,
            scaler_out, module.to(device), meta["n_halo"],
        )


@register_training_function(
    "convolutional", ConvolutionalHyperparameters
)
def train_convolutional_model(
    hyperparameters: ConvolutionalHyperparameters,
    train_batches,
    validation_batches=None,
    input_variables=None,
    output_variables=None,
    device=None,
) -> ConvolutionalModel:
    """Train the CNN in float32 on `device` (the CUDA device unless the
    caller names one), one cube (6 tiles) a step, in batch order."""
    hp = hyperparameters
    device = _shared.train_device(device, "train_convolutional_model")
    batches = list(train_batches)
    Xs, Ys = [], []
    for b in batches:
        x, widths_in = _stack_channels(b, input_variables)
        y, widths_out = _stack_channels(b, output_variables)
        Xs.append(x)
        Ys.append(y)
    X = np.concatenate(Xs)  # [n_tiles_total, y, x, c]
    Y = np.concatenate(Ys)
    scaler_in = _ChannelScaler().fit(X)
    scaler_out = _ChannelScaler().fit(Y)
    Xn = ((X - scaler_in.mean) / scaler_in.std).astype(np.float32)
    Yn = ((Y - scaler_out.mean) / scaler_out.std).astype(np.float32)

    n_halo = _halo_radius(hp)
    module = _CNN(X.shape[-1], hp.filters, hp.depth, hp.kernel_size,
                  Y.shape[-1])
    _shared.init_params(module, hp.seed)
    module.to(device)
    optimizer = _shared.adam(module, hp.learning_rate)

    def loss_fn(module, xb, yb):
        return torch.mean((_forward(module, xb, n_halo) - yb) ** 2)

    # each batch is one cube (6 tiles) -- halo append needs whole cubes
    xb_all = torch.as_tensor(Xn, device=device)
    yb_all = torch.as_tensor(Yn, device=device)
    n_cubes = X.shape[0] // 6
    with _float32_convolutions():
        _shared.run_steps(module, optimizer, loss_fn, (
            (xb_all[6 * c : 6 * (c + 1)], yb_all[6 * c : 6 * (c + 1)])
            for _ in range(hp.epochs) for c in range(n_cubes)))
    return ConvolutionalModel(
        list(input_variables), list(output_variables), widths_in,
        widths_out, scaler_in, scaler_out, module, n_halo,
    )
