"""Graph-network trainer on the cubed sphere (the JAX package's
``fit/graph.py``, the ``graph`` training function; fv3fit
pytorch/graph/train.py:65: UNet / MPG message passing over cubed-sphere
nodes).

On the cube the graph is a fixed-degree 4-neighbour grid graph whose only
irregularity is the 12 face seams, so message passing is a cube-topology
halo append (``fit.convolutional.append_halos``, the port's
``halo_exchange`` gather) and shifts of the padded block; the edge and
node MLPs are ``nn.Linear`` layers on [6, y, x, c] blocks.  The
graph-UNet pools by 2x2 block means and unpools by nearest-neighbour
repeats.  The loss's gradient flows back through the append's gather
(autograd's scatter-add, whose additions on the card come in no fixed
order).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch
from torch import nn

from ..convert import module_from_flat, module_to_flat, nested_flax_layers
from ..graphs import jit
from . import _shared
from ._shared import (
    Predictor,
    StandardScaler,
    register,
    register_training_function,
)
from .convolutional import (
    _ChannelScaler,
    _num_channels,
    _stack_channels,
    _unstack_channels,
    append_halos,
)


@dataclasses.dataclass
class GraphHyperparameters:
    """(fv3fit/pytorch/graph/train.py GraphHyperparameters subset)"""

    architecture: str = "mpg"  # "mpg" (message passing) | "unet"
    width: int = 32
    depth: int = 3  # message-passing rounds / unet levels
    epochs: int = 10
    learning_rate: float = 1e-3
    seed: int = 0


class _MessagePassing(nn.Module):
    """One round: an edge MLP on each (node, neighbour) pair of the four
    neighbours (flax ``Dense_0``-``Dense_3``: north, south, east, west),
    summed, then a node update (``Dense_4``).  Residual where the input
    has the round's width."""

    def __init__(self, n_in: int, width: int):
        super().__init__()
        self.width = width
        self.edges = nn.ModuleList(nn.Linear(2 * n_in, width)
                                   for _ in range(4))
        self.node = nn.Linear(n_in + width, width)

    def forward(self, x):  # [6, y, x, c] cube-tile block
        h = append_halos(x, 1)  # [6, y+2, x+2, c]
        neighbours = (h[:, 2:, 1:-1], h[:, :-2, 1:-1],
                      h[:, 1:-1, 2:], h[:, 1:-1, :-2])
        msgs = 0.0
        for edge, nb in zip(self.edges, neighbours):
            msgs = msgs + edge(torch.cat([x, nb], dim=-1))
        upd = self.node(torch.cat([x, torch.relu(msgs)], dim=-1))
        if x.shape[-1] == self.width:
            return x + torch.relu(upd)
        return torch.relu(upd)

    def flax_layers(self):
        layers = {f"Dense_{i}": m for i, m in enumerate(self.edges)}
        layers["Dense_4"] = self.node
        return layers


class _GraphMPG(nn.Module):
    """flax ``Dense_0`` (embedding), ``_MessagePassing_i``, ``Dense_1``
    (head)."""

    def __init__(self, n_in: int, width: int, depth: int, n_out: int):
        super().__init__()
        self.embed = nn.Linear(n_in, width)
        self.rounds = nn.ModuleList(_MessagePassing(width, width)
                                    for _ in range(depth))
        self.head = nn.Linear(width, n_out)

    def forward(self, x):
        x = self.embed(x)
        for mp in self.rounds:
            x = mp(x)
        return self.head(x)

    def flax_layers(self):
        layers = {"Dense_0": self.embed, "Dense_1": self.head}
        for i, mp in enumerate(self.rounds):
            layers.update(nested_flax_layers(f"_MessagePassing_{i}", mp))
        return layers


def _pool2(x):  # [6, y, x, c] -> [6, y/2, x/2, c] block mean
    s = x.shape
    return x.reshape(s[0], s[1] // 2, 2, s[2] // 2, 2, s[3]).mean((2, 4))


def _unpool2(x):  # nearest-neighbour upsample
    return torch.repeat_interleave(torch.repeat_interleave(x, 2, dim=1),
                                   2, dim=2)


class _GraphUNet(nn.Module):
    """Graph-UNet: message passing at each level of the cube quad-tree
    with skip connections.  flax names, in the order flax creates them:
    ``Dense_0`` (embedding), ``_MessagePassing_0..depth-1`` going down,
    ``_MessagePassing_depth`` at the bottom, then for each level going up
    ``Dense_{1+j}`` (the skip merge) and ``_MessagePassing_{depth+1+j}``,
    and ``Dense_{depth+1}`` (head).  It pools while the tile is at least
    4 wide."""

    def __init__(self, n_in: int, width: int, depth: int, n_out: int):
        super().__init__()
        self.depth = depth
        self.embed = nn.Linear(n_in, width)
        self.down = nn.ModuleList(_MessagePassing(width, width)
                                  for _ in range(depth))
        self.bottom = _MessagePassing(width, width)
        self.merge = nn.ModuleList(nn.Linear(2 * width, width)
                                   for _ in range(depth))
        self.up = nn.ModuleList(_MessagePassing(width, width)
                                for _ in range(depth))
        self.head = nn.Linear(width, n_out)

    def forward(self, x):
        x = self.embed(x)
        skips = []
        for mp in self.down:
            x = mp(x)
            skips.append(x)
            if min(x.shape[1], x.shape[2]) >= 4:
                x = _pool2(x)
        x = self.bottom(x)
        for j, level in enumerate(reversed(range(self.depth))):
            skip = skips[level]
            if x.shape[1] != skip.shape[1]:
                x = _unpool2(x)
            x = self.merge[j](torch.cat([x, skip], dim=-1))
            x = self.up[j](x)
        return self.head(x)

    def flax_layers(self):
        d = self.depth
        layers = {"Dense_0": self.embed, f"Dense_{d + 1}": self.head}
        rounds = list(self.down) + [self.bottom] + list(self.up)
        for i, mp in enumerate(rounds):
            layers.update(nested_flax_layers(f"_MessagePassing_{i}", mp))
        for j, m in enumerate(self.merge):
            layers[f"Dense_{1 + j}"] = m
        return layers


def _build(hp: GraphHyperparameters, n_in: int, n_out: int) -> nn.Module:
    if hp.architecture == "unet":
        return _GraphUNet(n_in, hp.width, hp.depth, n_out)
    if hp.architecture == "mpg":
        return _GraphMPG(n_in, hp.width, hp.depth, n_out)
    raise ValueError(f"unknown graph architecture {hp.architecture}")


@register("graph")
class GraphModel(Predictor):
    def __init__(self, input_variables, output_variables, widths_in,
                 widths_out, scaler_in, scaler_out, hp, module):
        super().__init__(input_variables, output_variables)
        self.widths_in = widths_in
        self.widths_out = widths_out
        self.scaler_in = scaler_in
        self.scaler_out = scaler_out
        self.hp = hp
        self.module = module.float().eval()
        self._apply = jit(_shared.no_grad(self.module))

    def predict(self, X):
        """One cube (6 tiles) on the model's device; returns numpy."""
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
            "hp": dataclasses.asdict(self.hp),
            "n_in": _num_channels(self.widths_in),
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, device) -> "GraphModel":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        hp = GraphHyperparameters(**meta["hp"])
        module = _build(hp, meta["n_in"], _num_channels(meta["widths_out"]))
        module_from_flat(module, np.load(os.path.join(path, "params.npy")))
        return cls(
            meta["input_variables"], meta["output_variables"],
            meta["widths_in"], meta["widths_out"],
            StandardScaler.load_from(os.path.join(path, "scaler_in.npz")),
            StandardScaler.load_from(os.path.join(path, "scaler_out.npz")),
            hp, module.to(device),
        )


def _mse(module, xb, yb):
    return torch.mean((module(xb) - yb) ** 2)


@register_training_function("graph", GraphHyperparameters)
def train_graph_model(
    hyperparameters: GraphHyperparameters,
    train_batches,
    validation_batches=None,
    input_variables=None,
    output_variables=None,
    device=None,
) -> GraphModel:
    """Train in float32 on `device` (the CUDA device unless the caller
    names one), one cube (6 tiles) a step, in sample order."""
    hp = hyperparameters
    device = _shared.train_device(device, "train_graph_model")
    Xs, Ys = [], []
    for b in train_batches:
        x, widths_in = _stack_channels(b, input_variables)
        y, widths_out = _stack_channels(b, output_variables)
        Xs.append(x)
        Ys.append(y)
    X = np.concatenate(Xs)
    Y = np.concatenate(Ys)
    scaler_in = _ChannelScaler().fit(X)
    scaler_out = _ChannelScaler().fit(Y)
    Xn = torch.as_tensor(
        ((X - scaler_in.mean) / scaler_in.std).astype(np.float32),
        device=device)
    Yn = torch.as_tensor(
        ((Y - scaler_out.mean) / scaler_out.std).astype(np.float32),
        device=device)

    module = _build(hp, X.shape[-1], Y.shape[-1])
    _shared.init_params(module, hp.seed)
    module.to(device)
    optimizer = _shared.adam(module, hp.learning_rate)
    n_cubes = X.shape[0] // 6
    _shared.run_steps(module, optimizer, _mse, (
        (Xn[6 * c : 6 * (c + 1)], Yn[6 * c : 6 * (c + 1)])
        for _ in range(hp.epochs) for c in range(n_cubes)))
    return GraphModel(
        list(input_variables), list(output_variables), widths_in,
        widths_out, scaler_in, scaler_out, hp, module,
    )
