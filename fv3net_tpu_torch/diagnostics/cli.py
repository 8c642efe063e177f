"""The diagnostics CLI of the port (the JAX package's
``diagnostics/cli.py``): the ``offline`` subcommand, which evaluates a
trained model against a mapper (workflows/diagnostics/fv3net/
diagnostics/offline/compute.py main).

    python -m fv3net_tpu_torch.diagnostics.cli offline MODEL DATA_YAML \
        -o OUTDIR [--no-jacobian] [--device DEVICE]

The model predicts on the CUDA device unless --device names another
(``--device cpu``).  The JAX package's other subcommands (``compute``,
``metrics``, ``report``, ``movies``, ``log-viewer``, ``single-run``,
``shell``) read a prognostic run's diagnostics through
``diagnostics/compute.py`` and ``utils/interpolate.py``, which are not
ported.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np


def offline_cmd(model_path: str, data_yaml: str, output: str,
                no_jacobian: bool = False, device=None) -> Dict[str, float]:
    """Evaluate a dumped Predictor against a mapper's test split
    (workflows/diagnostics/fv3net/diagnostics/offline/compute.py main).

    data_yaml schema::

        mapper_function: open_nudge_to_fine      # data registry name
        mapper_kwargs: {url: /path/to/run}
        timesteps: [ ... ]                       # optional test split
        grid: {resolution: 48}                   # optional; default
                                                 # inferred from data
    """
    import yaml

    from ..data import mapper_functions
    from ..grid import CubedSphereGrid
    from .offline import evaluate

    with open(data_yaml) as f:
        spec = yaml.safe_load(f)
    fn = mapper_functions[spec["mapper_function"]]
    mapper = fn(**spec.get("mapper_kwargs", {}))
    times = spec.get("timesteps")
    n = spec.get("grid", {}).get("resolution")
    if n is None:
        sample = mapper[sorted(mapper.keys())[0]]
        n = next(
            np.asarray(q.values).shape[-1] for q in sample.values()
        )
    g = CubedSphereGrid.make(int(n), halo=3)
    sl = g.interior
    grid = {
        "area": np.asarray(g.area[sl]),
        "lat": np.asarray(g.lat[sl]),
        "lon": np.asarray(g.lon[sl]),
    }
    metrics = evaluate(
        model_path, mapper, grid, output, times=times,
        jacobian=not no_jacobian, device=device,
    )
    print(json.dumps(metrics, indent=2, sort_keys=True))
    return metrics


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="prognostic_run_diags")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser(
        "offline", help="evaluate a trained model against a mapper"
    )
    p.add_argument("model_path", help="dumped Predictor directory")
    p.add_argument("data_yaml", help="mapper spec YAML")
    p.add_argument("-o", "--output", default="offline_diags")
    p.add_argument("--no-jacobian", action="store_true")
    p.add_argument(
        "--device", default=None,
        help="torch device of the model (default: the CUDA device)",
    )
    args = parser.parse_args(argv)
    offline_cmd(args.model_path, args.data_yaml, args.output,
                args.no_jacobian, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
