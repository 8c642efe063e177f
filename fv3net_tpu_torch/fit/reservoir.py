"""Reservoir computing (the JAX package's ``fit/reservoir.py``; fv3fit
reservoir.py:31-123, domain.py:19-129, readout.py, model.py:5).

The reservoir matrices are dense masked random matrices and the leaky
echo-state update runs for every subdomain of every tile at once: one
step is a [6 * n_subdomains, n_input] x [n_input, state] product plus a
[state, state] one, on the model's device.  The readout is a closed-form
ridge regression (``torch.linalg.solve`` on the device).  The subdomain
packing (``RankDivider``), the normalisation and the spectral-radius
rescale (``np.linalg.eigvals`` in float64) are host numpy, copied.

Random draws: the port draws ``W_res``, its mask and ``W_in`` from a
``torch.Generator`` seeded with ``hp.seed`` (on the CPU, then moved to
the device), so its matrices are not the JAX package's, which come from
``jax.random``.  A dump of either package carries its matrices
(``arrays.npz``), and the parity tests carry JAX's across.

Subdomains at a tile edge see the tile's own edge values in their
overlap (``np.pad(mode="edge")``), not the neighbouring tile's: the
JAX package's quirk, copied (ROADMAP quirk (n)).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence

import numpy as np
import torch

from ..device import default_device
from ..graphs import jit
from . import _shared
from ._shared import Predictor, register, register_training_function


@dataclasses.dataclass
class ReservoirHyperparameters:
    """(fv3fit/reservoir/config.py subset)"""

    state_size: int = 512
    adjacency_sparsity: float = 0.95  # fraction of W_res zeros
    spectral_radius: float = 0.6
    input_scaling: float = 0.5
    leakage: float = 0.5  # alpha
    ridge: float = 1.0e-6
    quadratic_features: bool = True
    subdomain_layout: Sequence[int] = (2, 2)
    overlap: int = 1
    burn_in: int = 10
    seed: int = 0


class RankDivider:
    """Split [ny, nx] into layout[0] x layout[1] overlapping subdomains
    (fv3fit/reservoir/domain.py:19-129).  Input views include `overlap`
    halo cells (clipped at tile edges); output views are the interior
    partition."""

    def __init__(self, layout, ny, nx, overlap):
        self.layout = tuple(layout)
        self.ny, self.nx = ny, nx
        self.overlap = overlap
        if ny % layout[0] or nx % layout[1]:
            raise ValueError("layout must evenly divide the tile")
        self.sub_ny = ny // layout[0]
        self.sub_nx = nx // layout[1]
        self._views = []
        for jy in range(layout[0]):
            for jx in range(layout[1]):
                y0, y1 = jy * self.sub_ny, (jy + 1) * self.sub_ny
                x0, x1 = jx * self.sub_nx, (jx + 1) * self.sub_nx
                yo0, yo1 = max(0, y0 - overlap), min(ny, y1 + overlap)
                xo0, xo1 = max(0, x0 - overlap), min(nx, x1 + overlap)
                self._views.append(
                    ((y0, y1, x0, x1), (yo0, yo1, xo0, xo1))
                )

    @property
    def n_subdomains(self):
        return self.layout[0] * self.layout[1]

    def subdomains_with_overlap(self, field: np.ndarray) -> np.ndarray:
        """field [..., ny, nx] -> [n_sub, ..., flat_features] (features
        = padded overlap window; edge windows are edge-padded so every
        subdomain has equal feature count)."""
        ow_y = self.sub_ny + 2 * self.overlap
        ow_x = self.sub_nx + 2 * self.overlap
        padded = np.pad(
            field,
            [(0, 0)] * (field.ndim - 2)
            + [(self.overlap, self.overlap)] * 2,
            mode="edge",
        )
        out = []
        for (y0, y1, x0, x1), _ in self._views:
            win = padded[..., y0 : y0 + ow_y, x0 : x0 + ow_x]
            out.append(win.reshape(win.shape[:-2] + (-1,)))
        return np.stack(out)

    def merge_subdomains(self, blocks: np.ndarray) -> np.ndarray:
        """[n_sub, ..., sub_ny*sub_nx] -> [..., ny, nx] interiors."""
        out = np.zeros(
            blocks.shape[1:-1] + (self.ny, self.nx), blocks.dtype
        )
        for i, ((y0, y1, x0, x1), _) in enumerate(self._views):
            out[..., y0:y1, x0:x1] = blocks[i].reshape(
                blocks.shape[1:-1] + (self.sub_ny, self.sub_nx)
            )
        return out


class Reservoir:
    """Leaky echo-state network core (fv3fit/reservoir/reservoir.py:31):
    float32 ``W_res`` [state, state] (masked, rescaled to the spectral
    radius) and ``W_in`` [state, n_input] on `device` (the CUDA device
    unless the caller names another)."""

    def __init__(self, hp: ReservoirHyperparameters, n_input: int,
                 device=None):
        if device is None:
            device = default_device("Reservoir")
        self.hp = hp
        gen = torch.Generator().manual_seed(int(hp.seed))
        shape = (hp.state_size, hp.state_size)
        w = torch.randn(shape, generator=gen)
        mask = torch.rand(shape, generator=gen) > hp.adjacency_sparsity
        w = (w * mask).double().numpy()
        # the spectral radius on the host, in float64
        eigmax = float(np.abs(np.linalg.eigvals(w)).max())
        self.W_res = torch.as_tensor(
            w * (hp.spectral_radius / max(eigmax, 1e-12)),
            dtype=torch.float32,
        ).to(device)
        self.W_in = (hp.input_scaling * (
            2.0 * torch.rand((hp.state_size, n_input), generator=gen) - 1.0
        )).to(device)
        self.n_input = n_input

    @classmethod
    def from_arrays(cls, hp, W_res, W_in, device) -> "Reservoir":
        """A reservoir with the given matrices (a dump's, or the JAX
        package's)."""
        res = cls.__new__(cls)
        res.hp = hp
        res.W_res = torch.as_tensor(np.asarray(W_res), device=device)
        res.W_in = torch.as_tensor(np.asarray(W_in), device=device)
        res.n_input = res.W_in.shape[1]
        return res

    def increment_state(self, u, x):
        """u [..., n_input], x [..., state] -> new x."""
        a = self.hp.leakage
        pre = u @ self.W_in.T + x @ self.W_res.T
        return (1.0 - a) * x + a * torch.tanh(pre)


def reservoir_states(reservoir: Reservoir, Un: torch.Tensor) -> torch.Tensor:
    """The echo states [T, B, state] of the normalised inputs Un [T, B,
    n_input] from a zero state, one ``increment_state`` a time step (the
    JAX package's ``lax.scan``), on Un's device."""
    x = torch.zeros((Un.shape[1], reservoir.hp.state_size),
                    dtype=Un.dtype, device=Un.device)
    states = torch.empty((Un.shape[0],) + tuple(x.shape), dtype=Un.dtype,
                         device=Un.device)
    for t in range(Un.shape[0]):
        x = reservoir.increment_state(Un[t], x)
        states[t] = x
    return states


def _readout_features(x, quadratic: bool):
    return torch.cat([x, x * x], dim=-1) if quadratic else x


def ridge_fit(S, Y, lam):
    """W minimizing ||S W - Y||^2 + lam ||W||^2, on S's device."""
    n = S.shape[1]
    A = S.T @ S + lam * torch.eye(n, dtype=S.dtype, device=S.device)
    B = S.T @ Y
    return torch.linalg.solve(A, B)


def _pack(X, names, divider) -> np.ndarray:
    """The fields `names` of X as [6 * n_sub, features] float32 rows of
    each tile's subdomains (with the divider's overlap)."""
    fields = [np.asarray(X[n].values, np.float32) for n in names]
    stacked = np.concatenate(
        [f[:, None] if f.ndim == 3 else f for f in fields], axis=1
    )  # [6, c, y, x]
    subs = divider.subdomains_with_overlap(stacked)
    # [n_sub, 6, c*feat] -> [6*n_sub, features]
    return np.moveaxis(subs, 1, 0).reshape(6 * divider.n_subdomains, -1)


@register("reservoir")
class ReservoirComputingModel(Predictor):
    """(fv3fit/reservoir/model.py:5): stateful predictor -- call
    `synchronize(series)` on a burn-in window, then `predict(state)`
    advances the reservoir one step and returns the readout.  The
    reservoir state stays on the device of the model's matrices."""

    def __init__(self, input_variables, output_variables, hp,
                 reservoir: Reservoir, W_out, divider: RankDivider,
                 norm_in, norm_out):
        super().__init__(input_variables, output_variables)
        self.hp = hp
        self.reservoir = reservoir
        self.W_out = W_out
        self.divider = divider
        self.norm_in = norm_in  # (mean, std) over features
        self.norm_out = norm_out
        self.reset()
        # one echo-state step a dispatch (the JAX package's jitted _step)
        self._step = jit(self.reservoir.increment_state)

    @property
    def device(self) -> torch.device:
        return self.W_out.device

    def reset(self):
        self._x = torch.zeros(
            (6 * self.divider.n_subdomains, self.hp.state_size),
            dtype=torch.float32, device=self.device,
        )

    def _pack_inputs(self, X) -> np.ndarray:
        subs = _pack(X, self.input_variables, self.divider)
        return (subs - self.norm_in[0]) / self.norm_in[1]

    def increment(self, X):
        u = torch.as_tensor(np.asarray(self._pack_inputs(X), np.float32),
                            device=self.device)
        self._x = self._step(u, self._x)

    def synchronize(self, series):
        self.reset()
        for X in series:
            self.increment(X)

    def predict(self, X):
        from ..util.quantity import Quantity

        self.increment(X)
        feats = _readout_features(self._x, self.hp.quadratic_features)
        yn = (feats @ self.W_out).cpu().numpy()
        y = yn * self.norm_out[1] + self.norm_out[0]
        # unpack per-variable interiors
        out = {}
        nz_off = 0
        sub_feat = self.divider.sub_ny * self.divider.sub_nx
        y = y.reshape(6, self.divider.n_subdomains, -1)
        y = np.moveaxis(y, 1, 0)  # [n_sub, 6, out_features]
        for name in self.output_variables:
            width = self._out_widths[name]
            block = y[..., nz_off : nz_off + width * sub_feat]
            nz_off += width * sub_feat
            block = block.reshape(
                self.divider.n_subdomains, 6, width, sub_feat
            )
            merged = self.divider.merge_subdomains(block)
            if width == 1:
                out[name] = Quantity(
                    merged[:, 0], ("tile", "y", "x"), ""
                )
            else:
                out[name] = Quantity(
                    merged, ("tile", "z", "y", "x"), ""
                )
        return out

    def dump(self, path: str):
        np.savez(
            os.path.join(path, "arrays.npz"),
            W_res=self.reservoir.W_res.cpu().numpy(),
            W_in=self.reservoir.W_in.cpu().numpy(),
            W_out=self.W_out.cpu().numpy(),
            mean_in=self.norm_in[0], std_in=self.norm_in[1],
            mean_out=self.norm_out[0], std_out=self.norm_out[1],
        )
        meta = {
            "input_variables": self.input_variables,
            "output_variables": self.output_variables,
            "hp": dataclasses.asdict(self.hp),
            "ny": self.divider.ny, "nx": self.divider.nx,
            "out_widths": self._out_widths,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, device) -> "ReservoirComputingModel":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        hp_d = dict(meta["hp"])
        hp_d["subdomain_layout"] = tuple(hp_d["subdomain_layout"])
        hp = ReservoirHyperparameters(**hp_d)
        with np.load(os.path.join(path, "arrays.npz")) as arrays:
            a = {k: arrays[k] for k in arrays.files}
        divider = RankDivider(
            hp.subdomain_layout, meta["ny"], meta["nx"], hp.overlap
        )
        model = cls(
            meta["input_variables"], meta["output_variables"], hp,
            Reservoir.from_arrays(hp, a["W_res"], a["W_in"], device),
            torch.as_tensor(a["W_out"], device=device), divider,
            (a["mean_in"], a["std_in"]), (a["mean_out"], a["std_out"]),
        )
        model._out_widths = {
            k: int(v) for k, v in meta["out_widths"].items()
        }
        return model


def normalised_series(hp, series, input_variables, output_variables):
    """The host side of training: (divider, Un [T, B, n_in], Yn [T, B,
    n_out] float32 numpy, (mean_in, std_in), (mean_out, std_out),
    output widths) of a time series of states."""
    ref = np.asarray(series[0][input_variables[0]].values)
    ny, nx = ref.shape[-2], ref.shape[-1]
    divider = RankDivider(hp.subdomain_layout, ny, nx, hp.overlap)
    # interiors without overlap: the divider with overlap 0
    d0 = RankDivider(hp.subdomain_layout, ny, nx, 0)
    out_widths = {}

    def pack_out(X):
        blocks = []
        for n in output_variables:
            f = np.asarray(X[n].values, np.float32)
            if f.ndim == 3:
                f = f[:, None]
            out_widths[n] = f.shape[1]
            subs = d0.subdomains_with_overlap(f)
            blocks.append(
                np.moveaxis(subs, 1, 0).reshape(
                    6, divider.n_subdomains, -1
                )
            )
        cat = np.concatenate(blocks, axis=-1)
        return cat.reshape(6 * divider.n_subdomains, -1)

    U = np.stack([_pack(X, input_variables, divider) for X in series])
    Yall = np.stack([pack_out(X) for X in series])
    mean_in = U.mean(axis=(0, 1))
    std_in = U.std(axis=(0, 1)) + 1e-8
    mean_out = Yall.mean(axis=(0, 1))
    std_out = Yall.std(axis=(0, 1)) + 1e-8
    Un = ((U - mean_in) / std_in).astype(np.float32)
    Yn = ((Yall - mean_out) / std_out).astype(np.float32)
    return (divider, Un, Yn, (mean_in, std_in), (mean_out, std_out),
            out_widths)


@register_training_function("reservoir", ReservoirHyperparameters)
def train_reservoir_model(
    hyperparameters: ReservoirHyperparameters,
    train_batches,
    validation_batches=None,
    input_variables=None,
    output_variables=None,
    device=None,
) -> ReservoirComputingModel:
    """train_batches: a TIME SERIES of states (each a State dict); the
    model learns to map reservoir(u_t) -> y_{t+1} interiors.  The states
    and the readout are computed in float32 on `device` (the CUDA device
    unless the caller names one)."""
    hp = hyperparameters
    device = _shared.train_device(device, "train_reservoir_model")
    divider, Un, Yn, norm_in, norm_out, out_widths = normalised_series(
        hp, list(train_batches), input_variables, output_variables
    )
    reservoir = Reservoir(hp, Un.shape[-1], device)
    states = reservoir_states(reservoir, torch.as_tensor(Un, device=device))
    # the state at step t pairs with the target at step t + 1
    t0 = hp.burn_in
    S = _readout_features(
        states[t0:-1].reshape(-1, hp.state_size), hp.quadratic_features
    )
    Y = torch.as_tensor(Yn[t0 + 1 :].reshape(-1, Yn.shape[-1]),
                        device=device)
    W_out = ridge_fit(S, Y, hp.ridge)
    model = ReservoirComputingModel(
        list(input_variables), list(output_variables), hp, reservoir,
        W_out, divider, norm_in, norm_out,
    )
    model._out_widths = out_widths
    return model
