"""The coupled configuration of the JAX package's benchmark (bench.py
rung 3, ``_measure_coupled``) for the port.

C<n> x 63 nonhydrostatic dycore (k_split=1, n_split=6, hord=5, kord=9)
+ gray radiation + the GFS physics suite + a dense ML corrector (depth
2, width 64, inputs air temperature and specific humidity, outputs dQ1
and dQ2), dt_atmos 900 s, float32, from the wrapper's initial state.
The JAX benchmark trains its MLP for one epoch on synthetic waves; here
the weights are random from a seed, written in the JAX package's
``DenseModel.dump`` format and read back through ``fit.load``, with
output scales that give tendencies of physical size (dQ1 ~1e-5 K/s, dQ2
~1e-8 /s, as tests/test_compiled_loop.py scales its model).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..convert import flax_dense_params_to_flat
from . import names

RUNG3 = dict(
    npz=63, dt_atmos=900.0, physics_suite="gfs", do_radiation=True,
    hydrostatic=False,
)
DEPTH, WIDTH = 2, 64
INPUTS = [names.TEMP, names.SPHUM]
OUTPUTS = ["dQ1", "dQ2"]


def write_dense_artifact(path: str, nz: int, seed: int = 0,
                         depth: int = DEPTH, width: int = WIDTH) -> str:
    """Write a random dense model (flax's lecun-normal kernels, small
    biases) in the JAX package's dump format under `path`."""
    rng = np.random.RandomState(seed)
    n_in = n_out = 2 * nz
    sizes = [n_in] + [width] * depth + [n_out]
    params = {
        f"Dense_{i}": {
            "kernel": (rng.randn(a, b) / np.sqrt(a)).astype(np.float32),
            "bias": (0.1 * rng.randn(b)).astype(np.float32),
        }
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))
    }
    os.makedirs(path, exist_ok=True)
    np.save(os.path.join(path, "params.npy"), flax_dense_params_to_flat(params))
    with open(os.path.join(path, "name"), "w") as f:
        f.write("dense")
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({
            "input_variables": INPUTS, "output_variables": OUTPUTS,
            "widths": [width] * depth, "n_out": n_out, "n_in": n_in,
        }, f)
    for which, vars_ in (("in", INPUTS), ("out", OUTPUTS)):
        with open(os.path.join(path, f"packer_{which}.json"), "w") as f:
            json.dump({"names": vars_,
                       "feature_counts": {v: nz for v in vars_}}, f)
    ones = np.ones(nz)
    np.savez(os.path.join(path, "scaler_in.npz"),
             mean=np.concatenate([260.0 * ones, 5e-3 * ones]),
             std=np.concatenate([20.0 * ones, 5e-3 * ones]))
    np.savez(os.path.join(path, "scaler_out.npz"),
             mean=np.zeros(n_out),
             std=np.concatenate([1e-5 * ones, 1e-8 * ones]))
    return path


def initialize(n: int, device, artifact_dir: str, dtype: str = "float32",
               seed: int = 0):
    """Initialize the port's wrapper at C<n> with rung 3's configuration
    on `device` and load the dense model (written to artifact_dir).
    Returns (wrapper module, model)."""
    from .. import fit, wrapper

    wrapper.initialize(
        wrapper.ModelConfig(npx=n + 1, dtype=dtype, **RUNG3), device=device
    )
    write_dense_artifact(artifact_dir, RUNG3["npz"], seed)
    return wrapper, fit.load(artifact_dir)
