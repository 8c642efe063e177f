"""Kernels (``fv3net_tpu_torch/ops/cuda_*.py``, ``csrc/*.cu``): device ms
per step of the port's hand-written kernels in the traced stretch,
found by their device functions' names (``roofline.KERNELS``)."""

from portbench.roofline import kernel_of


def read(ctx):
    ms = sum(s for name, s in ctx.trace.op_seconds().items()
             if kernel_of(name)[0] is not None) * 1e3
    return ms / ctx.trace.steps if ms > 0 else None
