"""Operators and exchanges (the dycore's torch ops, the halo gathers and
their copies): device ms per step of every traced device op that is none
of the port's hand-written kernels."""

from portbench.roofline import kernel_of


def read(ctx):
    ms = sum(s for name, s in ctx.trace.op_seconds().items()
             if kernel_of(name)[0] is None) * 1e3
    return ms / ctx.trace.steps if ctx.trace.ops else None
