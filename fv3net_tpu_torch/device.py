"""The device the port's entry points run on when the caller names none.

The port is written for the card: an entry point that builds state or
metrics (``make_dycore_stepper``, ``benchmark_state``, ``rest_state``,
``SWMetrics.make``, ``convert.metrics_from_numpy``,
``convert.state_from_numpy``) puts them on the CUDA device unless the
caller passes ``device="cpu"``.  Without a CUDA device the default
raises; it never falls back to the CPU.
"""

from __future__ import annotations

import torch


def default_device(fn_name: str) -> torch.device:
    """The CUDA device, for `fn_name` called without a device; raises a
    RuntimeError naming `fn_name` where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{fn_name} runs on the CUDA device by default and none is "
            f"available: pass device=\"cpu\" to run it on the CPU"
        )
    return torch.device("cuda")
