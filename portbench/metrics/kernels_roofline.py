"""Kernels: the share (%) of the port's kernels' device time that their
roofline bound accounts for: the sum over the traced launches of each
launch's bound at the configuration's shapes (``roofline.KERNELS``),
over the kernels' device time."""

from portbench.roofline import KERNELS, kernel_of


def read(ctx):
    bound_ms = kernel_ms = 0.0
    for name, a, b in ctx.trace.ops:
        kernel, counted = kernel_of(name)
        if kernel is None:
            continue
        kernel_ms += (b - a) / 1e3
        if counted:
            bound_ms += KERNELS[kernel][1](ctx.cfg)
    if kernel_ms <= 0.0:
        return None
    return 100.0 * bound_ms / kernel_ms
