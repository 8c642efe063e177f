"""Per-block wall-clock timing (the JAX package's ``runtime/timing.py``
``Timer``; the reference's pace.util.Timer role, runtime/loop.py:272,681).

The clock is the host's: around GPU work it measures enqueue time unless
the block ends in a synchronisation.
"""

from __future__ import annotations

import contextlib
import time as _time
from typing import Dict, List


class Timer:
    """Accumulate wall-clock samples per named block."""

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
