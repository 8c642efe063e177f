"""The readings that the limits of ``correct`` are set from in the coupled
cell, in one process (the benchmark's own runs never run this): the
procedure of ``control.py`` for ``entries/coupled.py``.

* the program's: from each seed, the warm-up's steps and then `steps`
  of the cell's own coupled steps, with a step drawn among them as a run
  draws it, and the gaps of that step and of the first against the plain
  reference's coupled step in float32 (the lower readings);
* the control's: the plain reference with the state it takes and
  returns held in bfloat16, the nearest precision below the
  configuration's float32, put in the program's place on the same
  inputs, against the same float32 reference (the upper readings).

    python3 portbench/control_coupled.py --workload c48x63.coupled \\
        --seeds 1 2 3 --steps 490

prints one JSON line a seed (the numbers, each field's widest
|program - reference|, |reference - input| and |reference|, the
control's widest |control - reference|, and the widest-point gaps
``compare.gaps`` of program and control, which the check does not use)
and then the largest program
reading, the smallest control reading and the limit
lower^(1/3) x upper^(2/3) of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.compare import field_stats, gaps  # noqa: E402
from portbench.entries.coupled import (  # noqa: E402
    Entry, compared, reference_outputs, reference_step, state_fields)
from portbench.harness import WARM_STEPS  # noqa: E402
from portbench.reference import hydro as ref  # noqa: E402
from portbench.window import synchronize  # noqa: E402


def bf16(st):
    return ref.DycoreState(*(t.to(torch.bfloat16).float() for t in st))


def bf16_state(step):
    """The control of a coupled step: the plain reference with the state
    it takes and returns held in bfloat16."""
    def control(state, tsfc, total_precip, t):
        y = step(bf16(state), tsfc, total_precip, t)
        return y._replace(state=bf16(y.state))

    return control


def limit(lower: float, upper: float) -> float:
    """A limit between the program's reading and the control's, nearer
    the control's."""
    return lower ** (1 / 3) * upper ** (2 / 3)


def control_readings(cfg, traffic, seeds, steps, device):
    """[(seed, program numbers, control numbers, field stats)]."""
    entry, ref32, control, out = None, None, None, []
    for seed in seeds:
        if entry is None:
            entry = Entry(cfg, traffic, seed, device)
            ref32 = reference_step(cfg, entry.artifact, torch.float32,
                                   device)
            control = bf16_state(ref32)
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
        for name, (x, tp, t), got in entry.outputs():
            want = reference_outputs(ref32(x, entry.tsfc, tp, t))
            y = reference_outputs(control(x, entry.tsfc, tp, t))
            prog.update(compared(name, got, want))
            ctrl.update(compared(name, y, want))
            # the widest-point gaps besides, which the check does not use
            fields.update({f"widest_{k}": [v, c] for (k, v), c in zip(
                gaps(name, got["state"], want["state"]).items(),
                gaps(name, y["state"], want["state"]).values())})
            for (k, g), (_, w), (_, c), (_, b) in zip(*(
                    state_fields(s) for s in (got["state"], want["state"],
                                              y["state"], x))):
                fields[f"{name}_{k}"] = dict(
                    field_stats(g, w, b),
                    control=field_stats(c, w, b)["diff"])
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
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg_file = next(c["file"] for c in bench["configs"]
                    if c["name"] == cell["config"])
    cfg = json.loads((root / cfg_file).read_text())
    traffic = json.loads(
        (root / "portbench/traffic" / f"{cell['traffic']}.json").read_text())
    device = torch.device(args.device)
    t0 = time.time()
    rows = control_readings(cfg, traffic, args.seeds, args.steps, device)
    worst_prog, least_ctrl = {}, {}
    for seed, prog, ctrl, fields in rows:
        print(json.dumps({"seed": seed, "program": prog, "control": ctrl,
                          "fields": fields}), flush=True)
        for k, v in prog.items():
            worst_prog[k] = max(v, worst_prog.get(k, 0.0))
        for k, v in ctrl.items():
            least_ctrl[k] = min(v, least_ctrl.get(k, float("inf")))
    print(json.dumps({
        "workload": args.workload, "seeds": args.seeds, "steps": args.steps,
        "seconds": time.time() - t0, "program_max": worst_prog,
        "control_min": least_ctrl,
        "limits": {k: limit(v, least_ctrl[k]) for k, v in worst_prog.items()},
        "device": (torch.cuda.get_device_name() if device.type == "cuda"
                   else "cpu")}))


if __name__ == "__main__":
    main()
