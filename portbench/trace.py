"""The traced stretch: ``steps`` of the cell's steps under torch.profiler,
reduced to device intervals and the harness's own host spans.

The interval arithmetic follows the repository's ``chip_smoke.py``
(``trace_replay``) and ``fv3net_tpu_torch/step_profile.py``: device ops
are the profiler's events of device type CUDA, and the device is busy
where at least one of them runs (their union, so ops of concurrent
streams count once).  The traced window is the harness's
``portbench.window`` span: from the first step's issue to the end of the
wait for the device after the last.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Tuple

import torch

WINDOW = "portbench.window"
# the harness's host spans inside the traced window, by what the host
# was doing
SPANS = ("portbench.step", "portbench.prepare", "portbench.wait",
         "portbench.drain")


@dataclasses.dataclass
class Trace:
    steps: int
    window: Tuple[float, float]  # us, the profiler's clock
    ops: List[Tuple[str, float, float]]  # device ops (name, start, end)
    spans: List[Tuple[str, float, float]]  # host spans (name, start, end)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device ops' intervals within the window."""
        lo, hi = self.window
        out = []
        for a, b in sorted((max(a, lo), min(b, hi)) for _, a, b in self.ops):
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def op_seconds(self) -> Dict[str, float]:
        """Device seconds by op name."""
        out = collections.defaultdict(float)
        for name, a, b in self.ops:
            out[name] += (b - a) / 1e6
        return dict(out)

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Every idle gap of the device in the window (seconds), named by
        the host span that covers most of it."""
        lo, hi = self.window
        edges = [lo] + [t for ab in self.busy_intervals() for t in ab] + [hi]
        gaps = []
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            cover = collections.defaultdict(float)
            for name, s, e in self.spans:
                cover[name] += max(0.0, min(b, e) - max(a, s))
            name = max(cover, key=cover.get) if cover else "host"
            if not cover or cover[name] <= 0.0:
                name = "host"
            gaps.append((name, (b - a) / 1e6))
        return gaps


def _activities(device: torch.device):
    from torch.profiler import ProfilerActivity

    if device.type == "cuda":
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


def traced(entry, first: int, steps: int, in_flight: int,
           device: torch.device, log=None) -> Trace:
    """`steps` of `entry` under the profiler, issued as the window issues
    them (at most `in_flight` queued ahead), numbered on from `first`;
    the seconds of each phase go to `log`, a file."""
    from torch.profiler import profile, record_function

    from .window import event, synchronize

    synchronize(device)
    t0 = time.perf_counter()
    with profile(activities=_activities(device)) as prof:
        with record_function(WINDOW):
            ends = []
            for i in range(steps):
                if i >= in_flight:
                    with record_function("portbench.wait"):
                        ends[i - in_flight].synchronize()
                with record_function("portbench.prepare"):
                    entry.prepare(first + i)
                with record_function("portbench.step"):
                    entry.step()
                ends.append(event(device))
                ends[-1].record()
            with record_function("portbench.drain"):
                synchronize(device)
        t1 = time.perf_counter()
    t2 = time.perf_counter()
    # the profiler's raw events: building its FunctionEvent tree takes a
    # minute for a few thousand device ops; times in ns, kept in us
    cuda = torch.autograd.DeviceType.CUDA
    window, ops, spans = None, [], []
    for e in prof.profiler.kineto_results.events():
        name, a, b = e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == cuda and not name.startswith("portbench."):
            ops.append((name, a, b))
        elif e.device_type() == cuda:
            continue  # the harness's spans as the device timeline shows them
        elif name == WINDOW:
            window = (a, b)
        elif name in SPANS:
            spans.append((name, a, b))
    if log is not None:
        print(f"trace: {steps} steps; profiler on and steps {t1 - t0:.2f} s, "
              f"off {t2 - t1:.2f} s, events read "
              f"{time.perf_counter() - t2:.2f} s", file=log)
    return Trace(steps, window, ops, spans)
