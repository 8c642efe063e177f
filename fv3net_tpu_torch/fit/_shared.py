"""ML framework core abstractions (the JAX package's ``fit/_shared.py``;
fv3fit/_shared equivalents).

The Predictor contract, the io registry with its ``name`` file (dump and
load), the training-function registry, ``TrainingConfig``, array packing
of named fields to (sample, feature) matrices and back, and the standard
scaler.  Arrays may be numpy arrays or torch tensors; packing keeps the
kind it is given, and a tensor stays on its device.

``fit.load`` puts a model's parameters on the CUDA device unless the
caller names another, and raises without one.  A numpy state is predicted
on the model's device and comes back as numpy, as the JAX package's is.
Each family's apply is jitted where the JAX package jits it
(``graphs.jit`` of ``no_grad(module)``): on the card one replayed graph
for each input shape (at most ``graphs.MAX_CAPTURES`` a model), eager on
the CPU.

Training runs in float32 with Adam (``adam``: b1 0.9, b2 0.999, eps 1e-8
outside the square root, as ``optax.adam``); ``init_params`` draws the
initial weights as flax's defaults do, ``train_step`` takes one step,
``run_steps`` the loop of steps and ``run_rounds`` alternating steps of
several optimisers (CycleGAN's).  The families call them through this
module, so a test or a measuring script can replace any of them.
"""

from __future__ import annotations

import abc
import contextlib
import dataclasses
import functools
import json
import os
from typing import Callable, Dict, Iterable, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from ..device import default_device
from ..util.quantity import Quantity

State = Mapping[str, Quantity]

_IO_REGISTRY: Dict[str, type] = {}
_NAME_FILE = "name"
TRAINING_FUNCTIONS: Dict[str, Callable] = {}


class Predictor(abc.ABC):
    """The prediction contract (fv3fit/_shared/predictor.py:44)."""

    def __init__(
        self,
        input_variables: Iterable[str],
        output_variables: Iterable[str],
    ):
        self.input_variables = list(input_variables)
        self.output_variables = list(output_variables)

    @abc.abstractmethod
    def predict(self, X: State) -> State:
        ...

    def dump(self, path: str) -> None:
        raise NotImplementedError

    @classmethod
    def load(cls, path: str, device) -> "Predictor":
        raise NotImplementedError


def register(name: str):
    """Class decorator adding the model type to the io registry
    (io.py:17)."""

    def wrap(cls):
        _IO_REGISTRY[name] = cls
        cls._io_name = name
        return cls

    return wrap


def dump(model, path: str) -> None:
    """Write `model` to the directory `path` in the JAX package's format:
    a ``name`` file naming its type, then the model's own files
    (io.py:92)."""
    os.makedirs(path, exist_ok=True)
    name = getattr(model, "_io_name", None)
    if name is None:
        raise ValueError(
            f"{type(model).__name__} is not registered for io"
        )
    with open(os.path.join(path, _NAME_FILE), "w") as f:
        f.write(name)
    model.dump(path)


def load(path: str, device=None):
    """Load a model directory written by either package's ``fit.dump``
    (io.py:71): its ``name`` file selects the class.  The parameters go to
    `device` (the CUDA device unless the caller names one)."""
    if device is None:
        device = default_device("fit.load")
    with open(os.path.join(path, _NAME_FILE)) as f:
        name = f.read().strip()
    if name not in _IO_REGISTRY:
        raise NotImplementedError(
            f"model type {name!r} is not ported (ported: "
            f"{sorted(_IO_REGISTRY)})"
        )
    return _IO_REGISTRY[name].load(path, torch.device(device))


def register_training_function(name: str, hyperparameter_class=None):
    """(training_config.py:136)"""

    def wrap(fn):
        TRAINING_FUNCTIONS[name] = (fn, hyperparameter_class)
        return fn

    return wrap


def get_training_function(name: str):
    return TRAINING_FUNCTIONS[name][0]


def get_hyperparameter_class(name: str):
    return TRAINING_FUNCTIONS[name][1]


@dataclasses.dataclass
class TrainingConfig:
    """(training_config.py)"""

    model_type: str
    hyperparameters: dict = dataclasses.field(default_factory=dict)
    input_variables: Sequence[str] = ()
    output_variables: Sequence[str] = ()

    @classmethod
    def from_dict(cls, d: Mapping) -> "TrainingConfig":
        return cls(
            model_type=d["model_type"],
            hyperparameters=dict(d.get("hyperparameters", {})),
            input_variables=list(d.get("input_variables", [])),
            output_variables=list(d.get("output_variables", [])),
        )


def train_device(device, fn_name: str) -> torch.device:
    """The device a training function runs on: the one named, else the
    CUDA device (raises without one)."""
    return torch.device(device if device is not None
                        else default_device(fn_name))


def init_params(module: nn.Module, seed: int) -> None:
    """Initialise `module` in place as flax does by default: every Linear
    and Conv2d kernel from ``lecun_normal`` (a normal truncated at two
    standard deviations, scaled to variance 1 / fan_in) and zero biases,
    drawn in module order on the CPU from a ``torch.Generator`` seeded with
    `seed`.  (JAX's threefry draws cannot be matched: parity tests replace
    this function with one that loads the JAX package's initial
    parameters.)"""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
                # the truncated normal's standard deviation is 0.8796 of
                # the untruncated one (jax.nn.initializers.variance_scaling)
                m.weight.copy_(w * (fan_in ** -0.5 / 0.87962566103423978))
                m.bias.zero_()


def adam(module: nn.Module, learning_rate: float,
         b1: float = 0.9) -> torch.optim.Adam:
    """``optax.adam(learning_rate, b1)``: b2 0.999, eps 1e-8 added
    outside the square root, no eps inside it.  torch computes the same
    update with its bias corrections folded into the step size and the
    denominator; it uses its multi-tensor (``foreach``) implementation on
    the CUDA device and its per-tensor loop on the CPU."""
    device = next(module.parameters()).device
    return torch.optim.Adam(
        module.parameters(), lr=learning_rate, betas=(b1, 0.999), eps=1e-8,
        foreach=device.type == "cuda",
    )


def train_step(module: nn.Module, optimizer, loss_fn, batch) -> torch.Tensor:
    """One optimiser step on `batch` (a tuple of tensors):
    ``loss_fn(module, *batch)``, its gradient, the Adam update.  Returns
    the loss (a tensor on the module's device; reading it synchronises)."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(module, *batch)
    loss.backward()
    optimizer.step()
    return loss.detach()


def run_steps(module: nn.Module, optimizer, loss_fn,
              batches: Iterable) -> list:
    """One ``train_step`` for each batch of `batches` (tuples of tensors),
    in order.  Returns each step's loss, tensors on the module's device
    that nothing has read (so the loop never waits for the device)."""
    return [train_step(module, optimizer, loss_fn, batch)
            for batch in batches]


def run_rounds(steps: Sequence, rounds: int) -> list:
    """`rounds` rounds of `steps`, each a (module, optimizer, loss_fn,
    batch) ``train_step`` taken in turn (CycleGAN's generator and
    discriminator steps).  Returns every step's loss, in order, unread."""
    return [train_step(*step) for _ in range(rounds) for step in steps]


def fit_epochs(module: nn.Module, optimizer, loss_fn, tensors: Sequence,
               batch_size: int, epochs: int, seed: int) -> list:
    """Train on the rows of `tensors` (on the module's device) as the JAX
    package does: each epoch a ``np.random.RandomState(seed)``
    permutation of the samples, cut into batches of `batch_size` (the last
    one short), one ``train_step`` a batch (``run_steps``).  Returns the
    steps' losses."""
    device = next(module.parameters()).device
    nsamp = tensors[0].shape[0]
    rng = np.random.RandomState(seed)

    def batches():
        for _ in range(epochs):
            perm = torch.as_tensor(rng.permutation(nsamp), device=device)
            for i in range(0, nsamp, batch_size):
                sel = perm[i : i + batch_size]
                yield tuple(t[sel] for t in tensors)

    return run_steps(module, optimizer, loss_fn, batches())


def _columns(arr):
    """[tile, z, y, x] -> [samples, z]; [tile, y, x] -> [samples, 1];
    [sample, feature] unchanged (numpy or torch)."""
    if arr.ndim == 4:
        nz = arr.shape[1]
        if isinstance(arr, torch.Tensor):
            return torch.movedim(arr, 1, -1).reshape(-1, nz)
        return np.moveaxis(arr, 1, -1).reshape(-1, nz)
    if arr.ndim == 3:
        return arr.reshape(-1, 1)
    if arr.ndim == 2:
        return arr
    raise ValueError(f"bad rank: {tuple(arr.shape)}")


class ArrayPacker:
    """Stack named fields into a (sample, feature) matrix and back
    (fv3fit/_shared/packer.py:45; stacking.py:12): 3D fields become
    per-column feature blocks of width nz, 2D fields one feature."""

    def __init__(self, names: Sequence[str]):
        self.names = list(names)
        self._feature_counts: Dict[str, int] = {}

    def to_array(self, state: State):
        """The (sample, feature) matrix: a tensor on the fields' device if
        any field is a tensor, else a numpy array."""
        blocks = []
        for name in self.names:
            arr = state[name].data
            if not isinstance(arr, torch.Tensor):
                arr = np.asarray(arr)
            block = _columns(arr)
            self._feature_counts[name] = block.shape[1]
            blocks.append(block)
        tensors = [b for b in blocks if isinstance(b, torch.Tensor)]
        if tensors:
            device = tensors[0].device
            return torch.cat(
                [torch.as_tensor(b, device=device) for b in blocks], dim=1
            )
        return np.concatenate(blocks, axis=1)

    def to_state(self, array, template: State) -> Dict[str, Quantity]:
        out = {}
        i = 0
        for name in self.names:
            width = self._feature_counts[name]
            block = array[:, i : i + width]
            i += width
            tq = template[name]
            tshape = tq.shape
            if len(tshape) == 4:
                arr = block.reshape(tshape[0], tshape[2], tshape[3],
                                    tshape[1])
                arr = (
                    torch.movedim(arr, -1, 1)
                    if isinstance(arr, torch.Tensor)
                    else np.moveaxis(arr, -1, 1)
                )
            elif len(tshape) == 3:
                arr = block.reshape(tshape)
            else:
                arr = block
            out[name] = tq.with_data(arr)
        return out

    def feature_count(self) -> int:
        return sum(self._feature_counts.values())

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(
                {"names": self.names,
                 "feature_counts": self._feature_counts}, f
            )

    @classmethod
    def load_from(cls, path: str) -> "ArrayPacker":
        with open(path) as f:
            d = json.load(f)
        p = cls(d["names"])
        p._feature_counts = {
            k: int(v) for k, v in d["feature_counts"].items()
        }
        return p


class StandardScaler:
    """(fv3fit/_shared/scaler.py): mean and std as host numpy arrays."""

    def __init__(self, std_epsilon: float = 1e-12):
        self.mean = None
        self.std = None
        self.std_epsilon = std_epsilon

    def fit(self, X: np.ndarray):
        self.mean = X.mean(axis=0)
        self.std = X.std(axis=0) + self.std_epsilon
        return self

    def normalize(self, X):
        return (X - self.mean) / self.std

    def denormalize(self, X):
        return X * self.std + self.mean

    def dump(self, path: str):
        np.savez(path, mean=self.mean, std=self.std)

    @classmethod
    def load_from(cls, path: str) -> "StandardScaler":
        with np.load(path) as d:
            s = cls()
            s.mean = d["mean"]
            s.std = d["std"]
        return s


def no_grad(fn: Callable, context: Callable = contextlib.nullcontext):
    """fn without gradients and within `context()`: the body of a
    predictor's jitted apply (the context's switches hold while a graph
    is captured, and so for its replays)."""
    @functools.wraps(fn)
    def call(*args):
        with torch.no_grad(), context():
            return fn(*args)

    if isinstance(fn, nn.Module):  # named after its class
        call.__qualname__ = type(fn).__qualname__
    return call


def run_on_device(module: nn.Module, x: np.ndarray, apply: Callable):
    """`apply` (the jitted ``no_grad(module)``) on the host array `x`
    (cast to float32) on the module's device; returns the output(s) as
    host numpy arrays."""
    device = next(module.parameters()).device
    y = apply(torch.as_tensor(np.asarray(x, np.float32), device=device))
    if isinstance(y, (list, tuple)):
        return [t.cpu().numpy() for t in y]
    return y.cpu().numpy()
