"""The readings that the limits of ``correct`` are set from, for one cell,
in one process (the benchmark's own runs never run this):

* the program's: from each seed, the warm-up's steps and then `steps`
  of the cell's own steps, with a dt drawn among them as a run draws
  it, and ``compare.gaps`` of that dt and of the first against the
  plain reference in float32 (the lower readings);
* the control's: the plain reference with the state it takes and
  returns held in bfloat16, the nearest precision below the
  configurations' float32, put in the program's place on the same
  inputs, against the same float32 reference (the upper readings).

    python3 portbench/control.py --workload c48x63.dycore \
        --seeds 1 2 3 --steps 380

prints one JSON line a seed (the numbers and each field's widest
|program - reference|, |reference - input| and |reference|) and then
the largest program reading and the smallest control reading of each
number.  ``control_readings`` serves the tests at a size a test run can
hold.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.compare import FIELDS, field_stats, gaps  # noqa: E402
from portbench.entries.dycore import Entry, reference_dt  # noqa: E402
from portbench.harness import WARM_STEPS  # noqa: E402
from portbench.reference import hydro as ref  # noqa: E402
from portbench.window import synchronize  # noqa: E402


def bf16_state(dt):
    """The control of a dt: the plain reference with the state it takes
    and returns held in bfloat16."""
    def control(x, phis):
        y = dt(ref.DycoreState(*(t.to(torch.bfloat16).float() for t in x)),
               phis)
        return ref.DycoreState(*(t.to(torch.bfloat16).float() for t in y))

    return control


def control_readings(cfg, traffic, seeds, steps, device):
    """[(seed, program numbers, control numbers, field stats)]."""
    ref32, _ = reference_dt(cfg, torch.float32, device)
    control = bf16_state(ref32)
    entry, out = None, []
    phis = torch.zeros((6, cfg["resolution"], cfg["resolution"]),
                       device=device)
    for seed in seeds:
        if entry is None:
            entry = Entry(cfg, traffic, seed, device)
        else:
            entry.restart(seed)
        for _ in range(WARM_STEPS):
            entry.prepare()
            entry.step()
        for i in range(steps):
            entry.prepare(i)
            entry.step()
        synchronize(device)
        prog, ctrl, fields = {}, {}, {}
        for name, x, got in entry.outputs():
            want = ref32(x, phis)
            y = control(x, phis)
            prog.update(gaps(name, got, want))
            ctrl.update(gaps(name, y, want))
            for k in FIELDS:
                fields[f"{name}_{k}"] = dict(
                    field_stats(getattr(got, k), getattr(want, k),
                                getattr(x, k)),
                    control=field_stats(getattr(y, k), getattr(want, k),
                                        getattr(x, k))["diff"])
        out.append((seed, prog, ctrl, fields))
    return out


def main(argv=None):
    root = Path(__file__).resolve().parent.parent
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--steps", type=int, required=True,
                   help="steps after the warm-up, as many as a window "
                        "holds")
    args = p.parse_args(argv)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg_file = next(c["file"] for c in bench["configs"]
                    if c["name"] == cell["config"])
    cfg = json.loads((root / cfg_file).read_text())
    traffic = json.loads(
        (root / "portbench/traffic" / f"{cell['traffic']}.json").read_text())
    t0 = time.time()
    rows = control_readings(cfg, traffic, args.seeds, args.steps,
                            torch.device("cuda"))
    worst_prog, least_ctrl = {}, {}
    for seed, prog, ctrl, fields in rows:
        print(json.dumps({"seed": seed, "program": prog, "control": ctrl,
                          "fields": fields}))
        for k, v in prog.items():
            worst_prog[k] = max(v, worst_prog.get(k, 0.0))
        for k, v in ctrl.items():
            least_ctrl[k] = min(v, least_ctrl.get(k, float("inf")))
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "steps": args.steps, "seconds": time.time() - t0,
                      "program_max": worst_prog, "control_min": least_ctrl,
                      "device": torch.cuda.get_device_name()}))


if __name__ == "__main__":
    main()
