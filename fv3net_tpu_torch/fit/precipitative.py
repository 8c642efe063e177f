"""Precipitative trainer (the `precipitative` training function,
fv3fit/keras/_models/precipitative.py:162).

Predicts column heating (dQ1), column moistening (dQ2) and surface
precipitation with the reference's physical coupling: the surface
precipitation output is the column integral of the drying
  P = -<dQ2> = -sum_k dQ2_k * delp_k / g   (clipped to P >= 0)
plus a learned residual column-process term, so the model's water
budget closes by construction.  The JAX package's
``fit/precipitative.py`` for the port: one MLP trunk (``Dense_i`` is
``layers[i]``) with three named linear heads (``q1_head``, ``q2_head``,
``precip_residual``, as flax names them), trained end to end in float32
with the precip constraint inside the loss.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..convert import module_from_flat, module_to_flat
from . import _shared
from ._shared import (
    ArrayPacker,
    Predictor,
    StandardScaler,
    register,
    register_training_function,
)
from ..constants import GRAV

DELP = "pressure_thickness_of_atmospheric_layer"
PRECIP = "total_precipitation_rate"
Q1 = "dQ1"
Q2 = "dQ2"


@dataclasses.dataclass
class PrecipitativeHyperparameters:
    """(fv3fit PrecipitativeHyperparameters subset)"""

    depth: int = 3
    width: int = 64
    epochs: int = 20
    batch_size: int = 512
    learning_rate: float = 1e-3
    precip_loss_weight: float = 1.0
    seed: int = 0


class _Trunk(nn.Module):
    def __init__(self, n_in: int, widths: Sequence[int], nz: int):
        super().__init__()
        self.widths = tuple(widths)
        self.nz = nz
        sizes = [n_in] + list(widths)
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:])
        )
        self.q1_head = nn.Linear(sizes[-1], nz)
        self.q2_head = nn.Linear(sizes[-1], nz)
        self.precip_residual = nn.Linear(sizes[-1], 1)

    def forward(self, x):
        h = x
        for layer in self.layers:
            h = torch.relu(layer(h))
        return self.q1_head(h), self.q2_head(h), self.precip_residual(h)

    def flax_layers(self):
        layers = {f"Dense_{i}": m for i, m in enumerate(self.layers)}
        layers.update(q1_head=self.q1_head, q2_head=self.q2_head,
                      precip_residual=self.precip_residual)
        return layers


def _physical_precip(q2_phys, delp, residual):
    """P = relu(-<dQ2> + residual) in kg/m^2/s (mm/s water equiv.)."""
    col = -(q2_phys * delp).sum(dim=-1) / GRAV
    return torch.relu(col + residual[..., 0])


@register("precipitative")
class PrecipitativeModel(Predictor):
    def __init__(self, input_variables, packer_in, scaler_in,
                 scaler_q1, scaler_q2, module, nz):
        super().__init__(
            input_variables, [Q1, Q2, PRECIP]
        )
        self.packer_in = packer_in
        self.scaler_in = scaler_in
        self.scaler_q1 = scaler_q1
        self.scaler_q2 = scaler_q2
        self.module = module.float().eval()
        self.nz = nz

    def _fwd(self, xn, delp):
        """The network on the model's device in float32, denormalised with
        the scalers in their own dtype, and the physical precipitation (as
        the JAX package's jitted forward with its numpy constants)."""
        device = next(self.module.parameters()).device

        def dev(a, dtype=None):
            return torch.as_tensor(np.asarray(a, dtype), device=device)

        with torch.no_grad():
            q1n, q2n, res = self.module(dev(xn, np.float32))
            q1 = q1n * dev(self.scaler_q1.std) + dev(self.scaler_q1.mean)
            q2 = q2n * dev(self.scaler_q2.std) + dev(self.scaler_q2.mean)
            precip = _physical_precip(q2, dev(delp, np.float32), res)
        return q1.cpu().numpy(), q2.cpu().numpy(), precip.cpu().numpy()

    def predict(self, X):
        from ..util.quantity import Quantity

        x = self.packer_in.to_array(X)
        xn = self.scaler_in.normalize(x).astype(np.float32)
        delp_q = X[DELP]
        delp = np.moveaxis(
            np.asarray(delp_q.values, np.float32), 1, -1
        ).reshape(-1, self.nz)
        q1, q2, precip = self._fwd(xn, delp)
        tshape = delp_q.shape  # [tile, z, y, x]

        def unstack(a):
            arr = np.asarray(a).reshape(
                tshape[0], tshape[2], tshape[3], self.nz
            )
            return np.moveaxis(arr, -1, 1)

        return {
            Q1: Quantity(unstack(q1), ("tile", "z", "y", "x"), "K/s"),
            Q2: Quantity(unstack(q2), ("tile", "z", "y", "x"),
                         "kg/kg/s"),
            PRECIP: Quantity(
                np.asarray(precip).reshape(
                    tshape[0], tshape[2], tshape[3]
                ),
                ("tile", "y", "x"), "kg/m**2/s",
            ),
        }

    def dump(self, path: str):
        self.packer_in.dump(os.path.join(path, "packer_in.json"))
        self.scaler_in.dump(os.path.join(path, "scaler_in.npz"))
        self.scaler_q1.dump(os.path.join(path, "scaler_q1.npz"))
        self.scaler_q2.dump(os.path.join(path, "scaler_q2.npz"))
        np.save(os.path.join(path, "params.npy"), module_to_flat(self.module))
        meta = {
            "input_variables": self.input_variables,
            "widths": list(self.module.widths),
            "nz": self.nz,
            "n_in": int(self.scaler_in.mean.shape[0]),
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, device) -> "PrecipitativeModel":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        module = _Trunk(meta["n_in"], meta["widths"], meta["nz"])
        module_from_flat(module, np.load(os.path.join(path, "params.npy")))
        return cls(
            meta["input_variables"],
            ArrayPacker.load_from(os.path.join(path, "packer_in.json")),
            StandardScaler.load_from(os.path.join(path, "scaler_in.npz")),
            StandardScaler.load_from(os.path.join(path, "scaler_q1.npz")),
            StandardScaler.load_from(os.path.join(path, "scaler_q2.npz")),
            module.to(device),
            meta["nz"],
        )


@register_training_function(
    "precipitative", PrecipitativeHyperparameters
)
def train_precipitative_model(
    hyperparameters: PrecipitativeHyperparameters,
    train_batches,
    validation_batches=None,
    input_variables=None,
    output_variables=None,
    device=None,
) -> PrecipitativeModel:
    """Targets required in each batch: dQ1, dQ2,
    total_precipitation_rate; delp must be among the inputs.  Trains in
    float32 on `device` (the CUDA device unless the caller names one)."""
    hp = hyperparameters
    if DELP not in input_variables:
        raise ValueError(f"precipitative model requires {DELP} input")
    device = _shared.train_device(device, "train_precipitative_model")
    batches = list(train_batches)
    packer_in = ArrayPacker(list(input_variables))
    pack_q1 = ArrayPacker([Q1])
    pack_q2 = ArrayPacker([Q2])
    pack_p = ArrayPacker([PRECIP])
    pack_delp = ArrayPacker([DELP])
    X = np.concatenate([packer_in.to_array(b) for b in batches])
    Yq1 = np.concatenate([pack_q1.to_array(b) for b in batches])
    Yq2 = np.concatenate([pack_q2.to_array(b) for b in batches])
    Yp = np.concatenate([pack_p.to_array(b) for b in batches])[:, 0]
    D = np.concatenate([pack_delp.to_array(b) for b in batches])
    nz = Yq1.shape[1]

    scaler_in = StandardScaler().fit(X)
    scaler_q1 = StandardScaler().fit(Yq1)
    scaler_q2 = StandardScaler().fit(Yq2)
    Xn = scaler_in.normalize(X).astype(np.float32)
    Yq1n = scaler_q1.normalize(Yq1).astype(np.float32)
    Yq2n = scaler_q2.normalize(Yq2).astype(np.float32)
    p_scale = float(Yp.std() + 1e-12)

    module = _Trunk(X.shape[1], (hp.width,) * hp.depth, nz)
    _shared.init_params(module, hp.seed)
    module.to(device)
    optimizer = _shared.adam(module, hp.learning_rate)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    s_q2_std = f32(scaler_q2.std)
    s_q2_mean = f32(scaler_q2.mean)

    def loss_fn(module, xb, y1b, y2b, pb, db):
        q1n, q2n, res = module(xb)
        q2_phys = q2n * s_q2_std + s_q2_mean
        pred_p = _physical_precip(q2_phys, db, res)
        return (
            torch.mean((q1n - y1b) ** 2)
            + torch.mean((q2n - y2b) ** 2)
            + hp.precip_loss_weight
            * torch.mean(((pred_p - pb) / p_scale) ** 2)
        )

    _shared.fit_epochs(
        module, optimizer, loss_fn,
        (f32(Xn), f32(Yq1n), f32(Yq2n), f32(Yp), f32(D)),
        hp.batch_size, hp.epochs, hp.seed,
    )
    return PrecipitativeModel(
        list(input_variables), packer_in, scaler_in, scaler_q1,
        scaler_q2, module, nz,
    )
