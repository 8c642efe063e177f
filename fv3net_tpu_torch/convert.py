"""Carry the JAX package's inputs and weights across as torch tensors.

The dycore has no trained weights: its "weights" are the metric terms
(``dycore.sw.SWMetrics``) and the hybrid coordinate.  These helpers take
plain numpy arrays -- e.g. ``np.asarray`` of every array field of a JAX
``SWMetrics`` or ``DycoreState`` -- so that both packages can step with
identical inputs.  The flax parameters of the JAX package's ``fit``
dumps (every family's ``params.npy``) map onto the port's ``nn.Linear``
and ``nn.Conv2d`` layers (the generative family's SAME convolutions and
transposed convolutions are ``nn.Conv2d`` subclasses with flax's kernel
layout).  Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .device import default_device
from .dycore.hydro import DycoreState
from .dycore.sw import SWMetrics


def metrics_from_numpy(arrays: Mapping, device=None,
                       dtype=None) -> SWMetrics:
    """SWMetrics from a mapping holding every tensor field of SWMetrics
    as an array, plus `n`, `halo` and `divdamp_scale`, on `device` (the
    CUDA device unless the caller names one).  Keys the port has no
    field for (None-valued tiling fields, scheme switches) are ignored.
    dtype: cast the arrays (default: keep theirs)."""
    if device is None:
        device = default_device("metrics_from_numpy")
    kw = {}
    for f in dataclasses.fields(SWMetrics):
        if f.name in ("n", "halo"):
            kw[f.name] = int(arrays[f.name])
        elif f.name == "divdamp_scale":
            kw[f.name] = float(arrays[f.name])
        else:
            kw[f.name] = torch.as_tensor(
                np.array(arrays[f.name]), dtype=dtype, device=device
            )
    return SWMetrics(**kw)


def state_from_numpy(arrays: Mapping, device=None,
                     dtype=None) -> DycoreState:
    """DycoreState from a mapping of field name -> array (or None), on
    `device` (the CUDA device unless the caller names one)."""
    if device is None:
        device = default_device("state_from_numpy")
    return DycoreState(**{
        k: None if arrays.get(k) is None else torch.as_tensor(
            np.array(arrays[k]), dtype=dtype, device=device
        )
        for k in DycoreState._fields
    })


def state_to_numpy(state: DycoreState) -> dict:
    """Field name -> numpy array (or None) of a DycoreState."""
    return {
        k: None if v is None else v.detach().cpu().numpy()
        for k, v in state._asdict().items()
    }


# --- ML models ---------------------------------------------------------------
#
# The JAX package dumps a flax model's parameters as ``params.npy``, the
# ``ravel_pytree`` vector of its params dict: dict keys sorted as strings at
# every level (so ``Dense_10`` comes before ``Dense_2``, and named heads such
# as ``q1_head`` after every ``Dense_i``), and within a layer ``bias`` before
# ``kernel``.  A Dense kernel is [in, out] (``nn.Linear``'s weight
# transposed), a Conv kernel [kh, kw, in, out] (HWIO; torch's Conv2d weight
# is OIHW; a flax ConvTranspose kernel is HWIO too, applied unflipped).
# A layer of a nested flax module is named by its path, the keys of each
# level joined by "/" (``_GRUCell_0/Dense_1``); layers are ordered as
# ``ravel_pytree`` orders them, by the tuple of their path's keys.
# ``shapes`` maps each layer name to its kernel shape; the bias has the
# kernel's last extent.


def _flax_order(name: str):
    return tuple(name.split("/"))


def flax_params_from_flat(flat: np.ndarray, shapes: Mapping) -> dict:
    """Unravel a ``params.npy`` vector into {name: {"bias", "kernel"}}
    numpy arrays, the layers of `shapes` ({name: kernel shape})."""
    flat = np.asarray(flat)
    params, i = {}, 0
    for name in sorted(shapes, key=_flax_order):
        kshape = tuple(shapes[name])
        bias = flat[i : i + kshape[-1]]
        i += kshape[-1]
        size = int(np.prod(kshape))
        kernel = flat[i : i + size].reshape(kshape)
        i += size
        params[name] = {"bias": bias, "kernel": kernel}
    if i != flat.size:
        raise ValueError(
            f"params.npy holds {flat.size} values, the layers {dict(shapes)}"
            f" need {i}"
        )
    return params


def flax_params_to_flat(params: Mapping) -> np.ndarray:
    """Inverse of flax_params_from_flat: the ``params.npy`` vector of a
    {name: {"bias", "kernel"}} dict."""
    return np.concatenate([
        np.asarray(params[name][k]).ravel()
        for name in sorted(params, key=_flax_order)
        for k in ("bias", "kernel")
    ])


def flax_params_flatten(params: Mapping, prefix: str = "") -> dict:
    """A nested flax params dict as {layer path: {"bias", "kernel"}}
    (numpy), the layer names ``flax_layers()`` uses."""
    out = {}
    for key, value in params.items():
        name = f"{prefix}{key}"
        if "kernel" in value:
            out[name] = {k: np.asarray(v) for k, v in value.items()}
        else:
            out.update(flax_params_flatten(value, f"{name}/"))
    return out


def _weight_from_kernel(kernel) -> torch.Tensor:
    kernel = np.asarray(kernel)
    if kernel.ndim == 4:  # HWIO -> OIHW
        return torch.tensor(kernel.transpose(3, 2, 0, 1).copy())
    return torch.tensor(kernel.T.copy())


def _kernel_from_weight(weight) -> np.ndarray:
    w = weight.detach().cpu().numpy()
    if w.ndim == 4:  # OIHW -> HWIO
        return w.transpose(2, 3, 1, 0).copy()
    return w.T.copy()


def nested_flax_layers(prefix: str, module) -> dict:
    """The ``flax_layers()`` of a submodule, named under `prefix` (its flax
    name in the parent)."""
    return {f"{prefix}/{k}": m for k, m in module.flax_layers().items()}


def module_flax_params(module) -> dict:
    """The flax params dict {name: {"bias", "kernel"}} (numpy) of one of
    the port's models: a module whose ``flax_layers()`` maps each flax
    layer name to its nn.Linear or nn.Conv2d."""
    return {
        name: {"bias": m.bias.detach().cpu().numpy(),
               "kernel": _kernel_from_weight(m.weight)}
        for name, m in module.flax_layers().items()
    }


def module_from_flax(module, params: Mapping) -> None:
    """Load a flax params dict (numpy) into one of the port's models."""
    with torch.no_grad():
        for name, m in module.flax_layers().items():
            m.weight.copy_(_weight_from_kernel(params[name]["kernel"]))
            m.bias.copy_(torch.as_tensor(np.asarray(params[name]["bias"])))


def module_to_flat(module) -> np.ndarray:
    """The ``params.npy`` vector of one of the port's models."""
    return flax_params_to_flat(module_flax_params(module))


def module_from_flat(module, flat: np.ndarray) -> None:
    """Load a ``params.npy`` vector into one of the port's models."""
    shapes = {name: tuple(_kernel_from_weight(m.weight).shape)
              for name, m in module.flax_layers().items()}
    module_from_flax(module, flax_params_from_flat(flat, shapes))
