"""Operators and exchanges: ms a dt of the vertical acoustics, FV3's
Riem_Solver (the program's device span ``dycore.riem_solver``: the
column pressures, the semi-implicit solve and the dz exchange), summed
over the dt's substeps, the median over the dts of the program's log."""

from portbench.clocks import stage_ms


def read(ctx):
    return stage_ms("dycore.riem_solver")
