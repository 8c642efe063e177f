"""Per-substep timing + scalar observability (a copy of the JAX
package's ``runtime/timing.py``).

The reference times every TimeLoop substep with ``pace.util.Timer``
(runtime/loop.py:272,681) and logs an MPI-reduced min/max/mean report
at the end of the run (``log_global_timings``, loop.py:516-543), plus
per-rank tensorboard scalar writers (runtime/main.py:47-49).  This
module provides the single-process equivalents: a ``Timer`` with
``clock(name)`` context managers (``tracing.Timer``), ``timing_report``
producing the min/max/mean-per-substep JSON with the device spans of
``tracing``'s log (FV3's routine clocks) and the process's set-up spans
(``tracing.HOST``) beside them, and a
dependency-free ``ScalarSink`` that appends JSONL scalar records a
report/CLI can consume.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping

from .. import tracing
from ..tracing import Timer

__all__ = ["Timer", "timing_report", "write_timing_json", "ScalarSink",
           "read_scalars"]


def _stats(samples: List[float]) -> Dict[str, float]:
    return {
        "min": min(samples),
        "max": max(samples),
        "mean": sum(samples) / len(samples),
        "total": sum(samples),
        "count": len(samples),
    }


def timing_report(timer: Timer) -> Dict[str, Dict[str, float]]:
    """min/max/mean/total seconds per substep name
    (log_global_timings, loop.py:516-543; single process, so the
    reduction is over steps instead of ranks); under ``host:<name>`` the
    same of the process's host spans of set-up (``tracing.HOST``); and
    under ``device:<span>`` the same of each device span's duration on
    the card (``tracing.device_spans``: the spans the log holds, since
    the process started or the last ``tracing.reset()``).  Where the log
    has wrapped, its spans are the newest ones only: a device entry then
    gives, in place of its total and count, the log's entries that were
    overwritten (``dropped``)."""
    out = {name: _stats(samples) for name, samples in timer.times.items()}
    for name, samples in tracing.HOST.times.items():
        out[f"host:{name}"] = _stats(samples)
    device: Dict[str, List[float]] = {}
    for s in tracing.device_spans():
        device.setdefault(s.name, []).append(s.ms / 1e3)
    lost = tracing.dropped() if device else 0
    for name, samples in device.items():
        stats = _stats(samples)
        if lost:
            del stats["total"], stats["count"]
            stats["dropped"] = lost
        out[f"device:{name}"] = stats
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
