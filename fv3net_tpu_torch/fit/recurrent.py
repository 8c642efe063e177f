"""Full-model-replacement recurrent trainer (the JAX package's
``fit/recurrent.py``, the ``fmr`` training function; fv3fit
pytorch/recurrent/train_fmr.py:446): given forcings and the current
state, a recurrent network predicts the next state, trained on a time
series.

Every cube column is one row of a [6 * y * x, features] batch.  The
recurrence (the JAX package's ``lax.scan``) is a Python loop over time on
the model's device; the loss unrolls T - 1 steps with teacher forcing
every ``train_rollout`` steps, and autograd backpropagates through the
loop (BPTT).  The gated cell is the JAX package's ``_GRUCell``, written
from ``nn.Linear`` layers: one Dense on [h, x] for each of the update and
reset gates and ``tanh(Dense([r * h, x]))`` for the candidate, which is
not the cell of ``torch.nn.GRU``.
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
)


@dataclasses.dataclass
class FMRHyperparameters:
    """(train_fmr.py FMRHyperparameters subset)"""

    hidden: int = 64
    epochs: int = 20
    learning_rate: float = 1e-3
    seed: int = 0
    train_rollout: int = 1  # steps of free-running in the loss


class _GRUCell(nn.Module):
    """flax ``Dense_0`` (update gate z), ``Dense_1`` (reset gate r),
    ``Dense_2`` (candidate n)."""

    def __init__(self, n_x: int, hidden: int):
        super().__init__()
        self.z = nn.Linear(hidden + n_x, hidden)
        self.r = nn.Linear(hidden + n_x, hidden)
        self.n = nn.Linear(hidden + n_x, hidden)

    def forward(self, h, x):
        hx = torch.cat([h, x], dim=-1)
        z = torch.sigmoid(self.z(hx))
        r = torch.sigmoid(self.r(hx))
        n = torch.tanh(self.n(torch.cat([r * h, x], dim=-1)))
        return (1.0 - z) * n + z * h

    def flax_layers(self):
        return {"Dense_0": self.z, "Dense_1": self.r, "Dense_2": self.n}


class _FMRCore(nn.Module):
    """One model step: (hidden, state, forcing) -> (hidden, next state).
    flax ``Dense_0`` the input layer, ``_GRUCell_0`` the cell, ``Dense_1``
    the state increment."""

    def __init__(self, hidden: int, n_state: int, n_forcing: int):
        super().__init__()
        self.hidden = hidden
        self.n_state = n_state
        self.n_forcing = n_forcing
        self.inp = nn.Linear(n_state + n_forcing, hidden)
        self.cell = _GRUCell(hidden, hidden)
        self.out = nn.Linear(hidden, n_state)

    def forward(self, h, state, forcing):
        x = torch.relu(self.inp(torch.cat([state, forcing], dim=-1)))
        h = self.cell(h, x)
        return h, state + self.out(h)

    def flax_layers(self):
        return {"Dense_0": self.inp, "Dense_1": self.out,
                **nested_flax_layers("_GRUCell_0", self.cell)}

    def rollout(self, state0, forcings):
        """state0 [cols, ns], forcings [T, cols, nf] -> the states of the
        T steps [T, cols, ns] (normalised units)."""
        h = torch.zeros(state0.shape[:-1] + (self.hidden,),
                        dtype=state0.dtype, device=state0.device)
        s, traj = state0, []
        for f in forcings:
            h, s = self(h, s, f)
            traj.append(s)
        return torch.stack(traj)


@register("fmr")
class FMRModel(Predictor):
    """Predicts a whole trajectory: `predict_rollout(state0, forcings)`;
    the Predictor.predict contract maps one step.  Runs on the device of
    the module's parameters; returns numpy."""

    def __init__(self, input_variables, output_variables, widths_in,
                 widths_out, scaler_in, scaler_out, hp, module):
        super().__init__(input_variables, output_variables)
        self.widths_in = widths_in
        self.widths_out = widths_out
        self.scaler_in = scaler_in
        self.scaler_out = scaler_out
        self.hp = hp
        self.module = module.float().eval()
        # the JAX package's jitted rollout
        self._jit_rollout = jit(_shared.no_grad(self.module.rollout))

    def _norm_in(self, x):
        return (x - self.scaler_in.mean) / self.scaler_in.std

    def _norm_out(self, y):
        return (y - self.scaler_out.mean) / self.scaler_out.std

    def _rollout(self, sn, fn):
        device = next(self.module.parameters()).device
        traj = self._jit_rollout(
            torch.as_tensor(np.asarray(sn, np.float32), device=device),
            torch.as_tensor(np.asarray(fn, np.float32), device=device),
        )
        return traj.cpu().numpy()

    def predict(self, X):
        """One step: forcing + current state (both read from X by
        name) -> next state."""
        f, _ = _stack_channels(X, self.input_variables)
        s, _ = _stack_channels(X, self.output_variables)
        shp = f.shape[:-1]
        fn = self._norm_in(f).reshape(-1, f.shape[-1])
        sn = self._norm_out(s).reshape(-1, s.shape[-1])
        traj = self._rollout(sn, fn[None])[0]
        y = (
            traj.reshape(shp + (traj.shape[-1],))
            * self.scaler_out.std + self.scaler_out.mean
        )
        return _unstack_channels(
            y, self.output_variables, self.widths_out
        )

    def predict_rollout(self, state0_np, forcings_np):
        """Free-running rollout: state0 [cols, ns] raw units, forcings
        [T, cols, nf] raw units -> [T, cols, ns] raw units."""
        traj = self._rollout(self._norm_out(state0_np),
                             self._norm_in(forcings_np))
        return traj * self.scaler_out.std + self.scaler_out.mean

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
            "n_out": _num_channels(self.widths_out),
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, device) -> "FMRModel":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        hp = FMRHyperparameters(**meta["hp"])
        module = _FMRCore(hp.hidden, meta["n_out"], meta["n_in"])
        module_from_flat(module, np.load(os.path.join(path, "params.npy")))
        return cls(
            meta["input_variables"], meta["output_variables"],
            meta["widths_in"], meta["widths_out"],
            StandardScaler.load_from(os.path.join(path, "scaler_in.npz")),
            StandardScaler.load_from(os.path.join(path, "scaler_out.npz")),
            hp, module.to(device),
        )


def _loss(k):
    """The mean squared error of the T - 1 unrolled steps, the state
    restarted from the data every `k` steps (teacher forcing)."""

    def loss_fn(module, Fc, Sc):
        h = torch.zeros((Fc.shape[1], module.hidden), dtype=Fc.dtype,
                        device=Fc.device)
        total = 0.0
        s = Sc[0]
        for t in range(Fc.shape[0] - 1):
            if t % k == 0:
                s = Sc[t]
            h, s = module(h, s, Fc[t])
            total = total + torch.mean((s - Sc[t + 1]) ** 2)
        return total / (Fc.shape[0] - 1)

    return loss_fn


@register_training_function("fmr", FMRHyperparameters)
def train_fmr_model(
    hyperparameters: FMRHyperparameters,
    train_batches,
    validation_batches=None,
    input_variables=None,
    output_variables=None,
    device=None,
) -> FMRModel:
    """train_batches: a TIME SERIES of states; input_variables are the
    forcings, output_variables the prognostic state the RNN replaces
    (train_fmr.py semantics).  One Adam step an epoch on the whole
    series, in float32 on `device` (the CUDA device unless the caller
    names one)."""
    hp = hyperparameters
    device = _shared.train_device(device, "train_fmr_model")
    Fs, Ss = [], []
    for b in train_batches:
        f, widths_in = _stack_channels(b, input_variables)
        s, widths_out = _stack_channels(b, output_variables)
        Fs.append(f)
        Ss.append(s)
    F = np.stack(Fs)  # [T, 6, y, x, nf]
    S = np.stack(Ss)  # [T, 6, y, x, ns]
    scaler_in = _ChannelScaler().fit(F)
    scaler_out = _ChannelScaler().fit(S)
    Fn = ((F - scaler_in.mean) / scaler_in.std).astype(np.float32)
    Sn = ((S - scaler_out.mean) / scaler_out.std).astype(np.float32)
    T = F.shape[0]
    Fc = torch.as_tensor(Fn.reshape(T, -1, F.shape[-1]), device=device)
    Sc = torch.as_tensor(Sn.reshape(T, -1, S.shape[-1]), device=device)

    module = _FMRCore(hp.hidden, S.shape[-1], F.shape[-1])
    _shared.init_params(module, hp.seed)
    module.to(device)
    optimizer = _shared.adam(module, hp.learning_rate)
    _shared.run_steps(module, optimizer, _loss(max(1, hp.train_rollout)),
                      ((Fc, Sc) for _ in range(hp.epochs)))
    return FMRModel(
        list(input_variables), list(output_variables), widths_in,
        widths_out, scaler_in, scaler_out, hp, module,
    )
