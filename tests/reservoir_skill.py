"""How well the reservoir family predicts a model series, in the JAX
package and in the port (CPU).

Runs the nudged case (``fv3net_tpu_torch.runtime.nudged_case``, without
the nudger) for STEPS steps at C<N> x 63 on the CPU, then trains each
package's reservoir at its default hyperparameters on the first T - 1
steps of the series (air temperature and specific humidity in and out)
for each T given, synchronises it on all but the last two steps and
predicts the last one.  Prints the mean absolute error of the prediction
over that of persistence (the last step but one) and over that of the
training steps' mean (climatology)::

    python tests/reservoir_skill.py N STEPS T [T ...]

e.g. ``python tests/reservoir_skill.py 12 160 64 100 160`` (about ten
minutes on four CPU cores).  The two packages draw different reservoir
matrices, so their numbers differ by the draw.
"""

import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(__file__))
import conftest  # noqa: E402,F401  (JAX on the CPU, float64 enabled)

from fv3net_tpu import fit as jfit  # noqa: E402
from fv3net_tpu.util.quantity import Quantity as JQuantity  # noqa: E402
from fv3net_tpu_torch import fit as tfit  # noqa: E402
from fv3net_tpu_torch.runtime import (  # noqa: E402
    derived_state,
    loop,
    names,
    nudged_case,
)
from fv3net_tpu_torch.util.quantity import Quantity as TQuantity  # noqa: E402

VARIABLES = [names.TEMP, names.SPHUM]
DIMS = ("tile", "z", "y", "x")


def series(n, steps):
    """T and q of each step of the nudged case run without its nudger."""
    with tempfile.TemporaryDirectory() as root:
        wm, _ = nudged_case.initialize(n, "cpu", root)
        mdl = wm.get_model()
        tl = loop.TimeLoop(wm, derived_state.DerivedModelState(wm),
                           mdl.config.dt_atmos, n_steps=steps)
        rows = {v: [] for v in VARIABLES}
        for _ in tl:
            for v in VARIABLES:
                rows[v].append(np.asarray(tl.state[v].values, np.float32))
    return {v: np.stack(r) for v, r in rows.items()}


def skill(arrays, T, pkg):
    f, Q = (jfit, JQuantity) if pkg == "jax" else (tfit, TQuantity)
    states = [{v: Q(arrays[v][t], DIMS) for v in VARIABLES}
              for t in range(T)]
    kw = {} if pkg == "jax" else {"device": "cpu"}
    model = f.train_reservoir_model(
        f.ReservoirHyperparameters(), states[:-1],
        input_variables=VARIABLES, output_variables=VARIABLES, **kw)
    model.synchronize(states[:-2])
    pred = model.predict(states[-2])
    out = {}
    for v in VARIABLES:
        truth = arrays[v][T - 1].astype(np.float64)
        err = np.abs(np.asarray(pred[v].values) - truth).mean()
        persistence = np.abs(arrays[v][T - 2] - truth).mean()
        climatology = np.abs(arrays[v][: T - 1].mean(0) - truth).mean()
        out[v] = (err / persistence, err / climatology)
    return out


def main(argv):
    n, steps, *Ts = (int(a) for a in argv)
    torch.set_num_threads(4)
    arrays = series(n, steps)
    for T in Ts:
        for pkg in ("jax", "port"):
            print(f"C{n} T={T} {pkg}: " + "; ".join(
                f"{v} error / persistence's {p:.3f}, / climatology's {c:.3f}"
                for v, (p, c) in skill(arrays, T, pkg).items()), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
