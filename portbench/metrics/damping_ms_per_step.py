"""Operators and exchanges: ms a dt of the wind damping (the program's
device span ``dycore.damping``: the divergence, vorticity and corner
dampers with their vjps), summed over the dt's substeps, the median over
the dts of the program's log."""

from portbench.clocks import stage_ms


def read(ctx):
    return stage_ms("dycore.damping")
