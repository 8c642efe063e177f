"""Operators and exchanges: ms a dt of the tracer transport, FV3's
tracer_2d (the program's device span ``dycore.tracer_2d``: the tracers'
exchanges and transports with the accumulated mass fluxes), the median
over the dts of the program's log."""

from portbench.clocks import stage_ms


def read(ctx):
    return stage_ms("dycore.tracer_2d")
