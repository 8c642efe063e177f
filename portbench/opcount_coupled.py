"""The operation count of one coupled step of a configuration, for
``step_mfu``: ``opcount.OpCounter`` (the BOUND_NOTE convention
of ``roofline.py``), with the corrector's matrix products besides
(``CoupledOpCounter``), over the plain reference's coupled step
(``reference/coupled.py``) at the configuration's shapes, from the
seed's input state of the coupled traffic, with the corrector written
from the seed as a run writes it.

    python3 portbench/opcount_coupled.py --config C48x63-gfs-ml
        [--device cpu] [--resolution N --nz NZ]

prints one JSON line with ``step_ops`` (run it on the card for the
configuration's own shapes; the value goes into the configuration's
file, with this command beside it).
"""

from __future__ import annotations

import argparse
import datetime
import json
import shutil
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.opcount import OpCounter  # noqa: E402


class CoupledOpCounter(OpCounter):
    """``OpCounter`` with the corrector's ops besides: a matrix product
    (``mm``, ``addmm``: the MLP's layers) as 2 m n k, its bias as one
    per output element, ``relu`` and ``isnan`` as one per element, and
    ``argmax`` as one per input element, as a reduction."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__.rstrip("_")
        if name not in ("mm", "addmm", "relu", "isnan", "argmax"):
            return super().__torch_dispatch__(func, types, args, kwargs)
        out = func(*args, **(kwargs or {}))
        if name in ("mm", "addmm"):
            a = args[-2]
            n = 2 * a.shape[0] * a.shape[1] * out.shape[1]
            n += out.numel() if name == "addmm" else 0
        elif name == "argmax":
            n = args[0].numel()
        else:
            n = out.numel()
        self.ops += n
        self.by_op[name] += n
        return out


def count_step(cfg, traffic, seed: int, device) -> OpCounter:
    """The operations of one reference coupled step of `cfg` from the
    seed's state."""
    from portbench.entries.coupled import (
        initial_state, reference_step, write_corrector)

    state, tsfc = initial_state(cfg, traffic, seed, device)
    artifact = write_corrector(tempfile.mkdtemp(prefix="coupled_dense_"),
                               cfg, state, seed)
    step = reference_step(cfg, artifact, torch.float32, device)
    shutil.rmtree(artifact, ignore_errors=True)
    t0 = datetime.datetime.fromisoformat(cfg["initial_time"])
    counter = CoupledOpCounter()
    with counter:
        step(state, tsfc, torch.zeros_like(tsfc), t0)
    return counter


def main(argv=None):
    root = Path(__file__).resolve().parent.parent
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resolution", type=int)
    p.add_argument("--nz", type=int)
    args = p.parse_args(argv)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == args.config)
    cfg = json.loads((root / entry["file"]).read_text())
    for k in ("resolution", "nz"):
        if getattr(args, k) is not None:
            cfg[k] = getattr(args, k)
    traffic = json.loads(
        (root / "portbench/traffic/coupled.json").read_text())
    c = count_step(cfg, traffic, args.seed, torch.device(args.device))
    print(json.dumps({
        "config": args.config, "resolution": cfg["resolution"],
        "nz": cfg["nz"], "step_ops": c.ops,
        "by_op": dict(c.by_op.most_common()),
        "uncounted": dict(c.uncounted),
    }))


if __name__ == "__main__":
    main()
