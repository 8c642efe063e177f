"""The coupled configuration of the JAX package's benchmark (bench.py
rung 3, ``_measure_coupled``) for the port.

C<n> x 63 nonhydrostatic dycore (k_split=1, n_split=6, hord=5, kord=9)
+ gray radiation + the GFS physics suite + a dense ML corrector (depth
2, width 64, inputs air temperature and specific humidity, outputs dQ1
and dQ2), dt_atmos 900 s, float32, from the wrapper's initial state.
The MLP is trained as bench.py trains it (``bench.py:225-235``): one
epoch of ``fit.train_dense_model`` (depth 2, width 64) on one batch of
``SyntheticWaves`` (n 8, seed 0), dumped in the JAX package's format and
read back through ``fit.load``.  One change: bench.py trains on the raw
waves, of size ~1 in every variable, so on the model's state (T ~ 250 K,
~200 of the waves' standard deviations out) its MLP predicts dQ1 of ~60
K/s and the coupled state is NaN after two steps (C12, f32, on the CPU).
Here each wave is first mapped onto a physical size (``PHYSICAL``: mean +
scale x wave, the waves' peak of ~4 giving dQ1 ~1e-5 K/s and dQ2 ~1e-8
/s), so the model's inputs lie within its training envelope.
"""

from __future__ import annotations

import numpy as np

from . import names

RUNG3 = dict(
    npz=63, dt_atmos=900.0, physics_suite="gfs", do_radiation=True,
    hydrostatic=False,
)
DEPTH, WIDTH = 2, 64
INPUTS = [names.TEMP, names.SPHUM]
OUTPUTS = ["dQ1", "dQ2"]
# (mean, scale) of each variable's training data: mean + scale x wave
PHYSICAL = {
    names.TEMP: (260.0, 10.0), names.SPHUM: (5e-3, 1.2e-3),
    "dQ1": (0.0, 2.5e-6), "dQ2": (0.0, 2.5e-9),
}


def train_dense_artifact(path: str, nz: int, device, depth: int = DEPTH,
                         width: int = WIDTH) -> str:
    """Train bench.py rung 3's MLP (one epoch on one batch of
    ``SyntheticWaves(n=8, nz, seed=0)``, each wave mapped onto its
    physical size) on `device` and dump it under `path`."""
    from .. import fit
    from ..data import SyntheticWaves

    batches = [
        {k: q.with_data((PHYSICAL[k][0] + PHYSICAL[k][1] * q.data).astype(
            np.float32)) for k, q in b.items()}
        for b in SyntheticWaves(INPUTS + OUTPUTS, n=8, nz=nz, nbatch=1,
                                seed=0).batches()
    ]
    model = fit.train_dense_model(
        fit.DenseHyperparameters(depth=depth, width=width, epochs=1),
        batches, input_variables=INPUTS, output_variables=OUTPUTS,
        device=device,
    )
    fit.dump(model, path)
    return path


def initialize(n: int, device, artifact_dir: str, dtype: str = "float32"):
    """Initialize the port's wrapper at C<n> with rung 3's configuration
    on `device` and load the dense model that ``train_dense_artifact``
    wrote to artifact_dir there.  Returns (wrapper module, model)."""
    from .. import fit, wrapper

    wrapper.initialize(
        wrapper.ModelConfig(npx=n + 1, dtype=dtype, **RUNG3), device=device
    )
    return wrapper, fit.load(artifact_dir, device)
