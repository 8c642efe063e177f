"""Carry the JAX package's inputs and weights across as torch tensors.

The dycore has no trained weights: its "weights" are the metric terms
(``dycore.sw.SWMetrics``) and the hybrid coordinate.  These helpers take
plain numpy arrays -- e.g. ``np.asarray`` of every array field of a JAX
``SWMetrics`` or ``DycoreState`` -- so that both packages can step with
identical inputs.  The dense ML model's flax parameters (the JAX
package's ``fit/dense.py`` dump format) map onto the port's ``nn.Linear``
layers.  Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .dycore.hydro import DycoreState
from .dycore.sw import SWMetrics


def metrics_from_numpy(arrays: Mapping, device="cpu",
                       dtype=None) -> SWMetrics:
    """SWMetrics from a mapping holding every tensor field of SWMetrics
    as an array, plus `n`, `halo` and `divdamp_scale`.  Keys the port
    has no field for (None-valued tiling fields, scheme switches) are
    ignored.  dtype: cast the arrays (default: keep theirs)."""
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


def state_from_numpy(arrays: Mapping, device="cpu",
                     dtype=None) -> DycoreState:
    """DycoreState from a mapping of field name -> array (or None)."""
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


# --- dense ML models --------------------------------------------------------


def _dense_layer_names(n_layers: int):
    """flax names of an MLP's Dense layers in jax.tree_util's flattening
    order: dict keys sorted as strings, so Dense_10 comes before Dense_2."""
    return sorted(f"Dense_{i}" for i in range(n_layers))


def flax_dense_params_from_flat(flat: np.ndarray, n_in: int,
                                widths, n_out: int) -> dict:
    """Unravel ``params.npy`` of the JAX package's ``DenseModel.dump``
    (``ravel_pytree`` of the flax params) into {"Dense_i": {"bias",
    "kernel"}} numpy arrays, kernel [in, out].  Within a layer the
    flattening order is bias, then kernel."""
    sizes = [n_in] + list(widths) + [n_out]
    flat = np.asarray(flat)
    params, i = {}, 0
    for name in _dense_layer_names(len(sizes) - 1):
        k = int(name.split("_")[1])
        fan_in, fan_out = sizes[k], sizes[k + 1]
        bias = flat[i : i + fan_out]
        i += fan_out
        kernel = flat[i : i + fan_in * fan_out].reshape(fan_in, fan_out)
        i += fan_in * fan_out
        params[name] = {"bias": bias, "kernel": kernel}
    if i != flat.size:
        raise ValueError(
            f"params.npy holds {flat.size} values, the MLP {sizes} needs {i}"
        )
    return params


def flax_dense_params_to_flat(params: Mapping) -> np.ndarray:
    """Inverse of flax_dense_params_from_flat: the ``params.npy`` vector
    of a {"Dense_i": {"bias", "kernel"}} dict."""
    return np.concatenate([
        np.asarray(params[name][k]).ravel()
        for name in _dense_layer_names(len(params))
        for k in ("bias", "kernel")
    ])


def dense_state_dict_from_flax(params: Mapping) -> dict:
    """A flax MLP params dict (numpy) -> the state dict of the port's
    ``fit.dense._MLP`` (``layers.i`` = flax ``Dense_i``; nn.Linear's weight
    is the flax kernel transposed)."""
    out = {}
    for name, p in params.items():
        i = int(name.split("_")[1])
        out[f"layers.{i}.weight"] = torch.tensor(np.asarray(p["kernel"]).T)
        out[f"layers.{i}.bias"] = torch.tensor(np.asarray(p["bias"]))
    return out
