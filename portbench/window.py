"""The measured window and its end-to-end arithmetic.

A window issues the cell's steps back to back, at most ``in_flight``
queued ahead of the device, for ``seconds`` of the host's clock, then
waits for the device: the window runs from its first step's issue to the
end of that wait, and every step issued is complete at its end.  Each
step's device time runs from a CUDA event recorded before it to one
recorded after it, with no synchronisation inside the window; each
step's host time is the host clock around the program's call alone.

On the CPU (the tests) the events are the host clock: the arithmetic is
the same, the numbers are no device's.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import List

import torch


class _HostEvent:
    """A stand-in for ``torch.cuda.Event`` on the CPU."""

    def __init__(self):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


def event(device: torch.device):
    if device.type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return _HostEvent()


def synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Window:
    steps: int
    elapsed_s: float
    step_ms: List[float]  # device time of each step (CUDA events)
    host_ms: List[float]  # host time of each step's call


def run_window(entry, seconds: float, in_flight: int,
               device: torch.device) -> Window:
    """Steps of `entry` back to back for `seconds` (see the module
    docstring)."""
    starts, ends, host = [], [], []
    synchronize(device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if len(ends) >= in_flight:
            ends[len(ends) - in_flight].synchronize()
        entry.prepare(len(ends))
        a, b = event(device), event(device)
        a.record()
        h0 = time.perf_counter()
        entry.step()
        host.append((time.perf_counter() - h0) * 1e3)
        b.record()
        starts.append(a)
        ends.append(b)
    synchronize(device)
    elapsed = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(starts, ends)]
    return Window(len(ends), elapsed, step_ms, host)


def sdpd(w: Window, dt_seconds: float) -> float:
    """Simulated days a wall day: the simulated seconds of the steps
    completed over the window's wall seconds."""
    return w.steps * dt_seconds / w.elapsed_s


def p95(values: List[float]) -> float:
    """The 95th percentile of all `values` (``statistics.quantiles``'
    exclusive method, n = 20)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20)[-1]

