"""One run of one cell: set-up, warm-up, the measured window, the traced
stretch (``--trace 1``), the check against the plain reference, and the
result line.

Everything that belongs to one configuration, traffic mix or metric is
found by its name in ``BENCHMARK.json``:

* the cell (``workloads``) names a configuration, whose ``file`` holds
  its sizes, scheme, operation count and limits, and a traffic mix,
  ``portbench/traffic/<traffic>.json``, whose ``entry`` names what
  drives the program's entry point, ``portbench/entries/<entry>.py``;
* each end-to-end metric is read by ``portbench/end_to_end/<name>.py``
  and each per-layer metric by ``portbench/metrics/<name>.py``: a
  function ``read(ctx)`` that returns a number, or None where it finds
  nothing to read (the metric is then left out of the line).

An entry module defines ``Entry(cfg, traffic, seed, device)`` (its
set-up), with ``dt_seconds``, ``prepare(i)`` (the harness's own work
before step i of the window and of the traced stretch after it, None in
the warm-up: keeping what the check needs), ``step()`` (the program's
call; no synchronisation) and ``check()`` (after the window: the
compared numbers by name).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from portbench.compare import judge
from portbench.trace import Trace, traced
from portbench.window import Window, run_window, synchronize

ROOT = Path(__file__).resolve().parent.parent
# what no run may load: compared by whole top-level module names
FORBIDDEN = ("jax", "jaxlib", "flax", "fv3net_tpu")
TOP = 10  # entries of each breakdown list
WARM_STEPS = 3
# On the H100 a C48 dt reads ~5% slower, at the same clocks, until 15-49
# s after its process started (PERF.md, section 2): the window opens no
# earlier than this after the process started, which leaves about one
# window in thirteen with a slow start.
OPEN_AT_S = 45.0


@dataclasses.dataclass
class Context:
    """What the metric readers read."""

    cfg: dict
    chips: int
    dt_seconds: float
    setup_s: float
    window: Window
    peak_bytes: int
    trace: Optional[Trace] = None


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find(items, name, what):
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def forbidden_modules():
    return sorted({k.split(".")[0] for k in sys.modules}
                  & set(FORBIDDEN))


def warm(entry, device):
    """Every cell's warm-up: ``WARM_STEPS`` steps, each waited for (the
    first builds and captures the entry's graph, the others replay
    it)."""
    for _ in range(WARM_STEPS):
        entry.prepare()
        entry.step()
        synchronize(device)


def launch_counts(steps: int) -> dict:
    """The port's launch counters (``ops._build.COUNTED``) per step of
    the window, where the program has them."""
    build = sys.modules.get("fv3net_tpu_torch.ops._build")
    if build is None or not steps:
        return {}
    return {k: w.launches / steps for k, w in build.COUNTED.items()
            if w.launches}


def reset_counts():
    build = sys.modules.get("fv3net_tpu_torch.ops._build")
    for w in (build.COUNTED.values() if build else ()):
        w.launches = 0


def main(argv=None, *, root: Path = ROOT, device=None, t_start=None,
         out=None, err=None) -> int:
    """One run (module docstring); returns the exit code.  `device`
    given (the tests: the CPU) skips the look for a card."""
    t_start = time.time() if t_start is None else t_start
    out = out or sys.stdout
    err = err or sys.stderr
    args = parse(argv)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = find(bench["workloads"], args.workload, "workload")
    cfg = json.loads((root / find(bench["configs"], cell["config"],
                                  "config")["file"]).read_text())
    here = root / "portbench"
    traffic = json.loads(
        (here / "traffic" / f"{cell['traffic']}.json").read_text())
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=err)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    entries = load_module(here / "entries" / f"{traffic['entry']}.py",
                          f"portbench_entry_{traffic['entry']}")

    entry = entries.Entry(cfg, traffic, args.seed, device)
    warm(entry, device)
    setup_s = time.time() - t_start
    # the card idles until the window may open: the harness's wait, not
    # the program's set-up
    time.sleep(max(0.0, OPEN_AT_S - (time.time() - t_start)))
    reset_counts()
    window = run_window(entry, args.seconds, traffic["in_flight"], device)
    launches = launch_counts(window.steps)
    trace = None
    if args.trace:
        steps = max(3, round(traffic["trace_seconds"] * window.steps
                             / window.elapsed_s))
        trace = traced(entry, window.steps, steps, traffic["in_flight"],
                       device, log=err)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    t_check = time.time()
    numbers = entry.check()
    t_check = time.time() - t_check
    limits = cfg.get("limits", {})
    correct = judge(numbers, limits)
    ctx = Context(cfg, cell["chips"], entry.dt_seconds, setup_s, window,
                  peak, trace)
    kind, folder = (("per_layer", "metrics") if args.trace
                    else ("end_to_end", "end_to_end"))
    metrics = {}
    for m in bench[kind]:
        if not applies(m, args.workload):
            continue
        reader = load_module(here / folder / f"{m['name']}.py",
                             f"portbench_{folder}_{m['name']}")
        value = reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": window.steps,
        "failed": 0,
        "metrics": metrics,
        "device": device_info(device, cell["chips"], peak, trace),
    }
    if trace is not None:
        result["breakdown"] = breakdown(trace)
    result["checks"] = {
        k: {"value": v if math.isfinite(v) else str(v),
            "limit": limits.get(k)} for k, v in numbers.items()
    }
    print(f"window: {window.steps} steps in {window.elapsed_s} s; step ms "
          f"by tenths of the window {tenths(window.step_ms)}; launches per "
          f"step {json.dumps(launches)}; set-up {setup_s:.2f} s, check "
          f"{t_check:.2f} s, {time.time() - t_start:.2f} s since start",
          file=err)
    # after every module of the run has been loaded, readers included
    found = forbidden_modules()
    if found:
        print(f"loaded in the run: {', '.join(found)}", file=err)
        return 3
    print(json.dumps(result), file=out, flush=True)
    for k, v in numbers.items():
        print(f"{k} {v!r} limit {limits.get(k)!r}", file=err)
    err.flush()
    return 0


def tenths(step_ms) -> list:
    """The median step of each tenth of the window, in ms."""
    k = max(1, len(step_ms) // 10)
    return [round(statistics.median(step_ms[i:i + k]), 3)
            for i in range(0, len(step_ms) - k + 1, k)]


def device_info(device, chips, peak, trace) -> dict:
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device)}
    else:
        info = {"platform": "cpu", "kind": "cpu"}
    info.update(count=chips, memory_peak_bytes=peak)
    if trace is not None:
        info.update(busy_s=trace.busy_s(), window_s=trace.window_s)
    return info


def breakdown(trace: Trace) -> dict:
    ops = sorted(trace.op_seconds().items(), key=lambda kv: -kv[1])
    gaps = sorted(trace.idle_gaps(), key=lambda kv: -kv[1])
    return {"device_ops": [[k[:160], s] for k, s in ops[:TOP]],
            "idle_gaps": [[k, s] for k, s in gaps[:TOP]]}
