"""Per-substep timing + scalar observability (a copy of the JAX
package's ``runtime/timing.py``).

The reference times every TimeLoop substep with ``pace.util.Timer``
(runtime/loop.py:272,681) and logs an MPI-reduced min/max/mean report
at the end of the run (``log_global_timings``, loop.py:516-543), plus
per-rank tensorboard scalar writers (runtime/main.py:47-49).  This
module provides the single-process equivalents: a ``Timer`` with
``clock(name)`` context managers, ``timing_report`` producing the
min/max/mean-per-substep JSON, and a dependency-free ``ScalarSink``
that appends JSONL scalar records a report/CLI can consume.
"""

from __future__ import annotations

import contextlib
import json
import os
import time as _time
from typing import Dict, List, Mapping


class Timer:
    """Accumulate wall-clock samples per named block
    (pace.util.Timer role).  The clock is the host's: around GPU work it
    measures enqueue time unless the block ends in a synchronisation."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def clock(self, name: str):
        t0 = _time.perf_counter()
        try:
            yield
        finally:
            self.times.setdefault(name, []).append(
                _time.perf_counter() - t0
            )

    def reset(self):
        self.times = {}


def timing_report(timer: Timer) -> Dict[str, Dict[str, float]]:
    """min/max/mean/total seconds per substep name
    (log_global_timings, loop.py:516-543; single process, so the
    reduction is over steps instead of ranks)."""
    out = {}
    for name, samples in timer.times.items():
        out[name] = {
            "min": min(samples),
            "max": max(samples),
            "mean": sum(samples) / len(samples),
            "total": sum(samples),
            "count": len(samples),
        }
    return out


def write_timing_json(timer: Timer, run_dir: str,
                      fname: str = "timing.json") -> str:
    path = os.path.join(run_dir, fname)
    with open(path, "w") as f:
        json.dump(timing_report(timer), f, indent=2, sort_keys=True)
    return path


class ScalarSink:
    """Append-only JSONL scalar stream (the tensorboard-writer role of
    runtime/main.py:47-49 / runtime/diagnostics/tensorboard.py, kept
    dependency-free): one record per (step, name) with the model time.
    """

    def __init__(self, run_dir: str, fname: str = "scalars.jsonl"):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, fname)
        self._f = open(self.path, "a")

    def write(self, step: int, time, scalars: Mapping[str, float]):
        for name, value in sorted(scalars.items()):
            rec = {
                "step": int(step),
                "time": str(time),
                "name": str(name),
                "value": float(value),
            }
            self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def read_scalars(path: str) -> Dict[str, List[dict]]:
    """Group a scalars.jsonl back into per-name series."""
    out: Dict[str, List[dict]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            out.setdefault(rec["name"], []).append(rec)
    return out
