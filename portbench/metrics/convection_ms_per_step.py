"""Physics: ms a coupled step of the SAS-style deep convection, its
updraft a recurrence over the levels, and the shallow convection (the
program's device span ``physics.convection``), the median over the
coupled steps of the program's log."""

from portbench.coupled_clocks import step_ms


def read(ctx):
    return step_ms("physics.convection")
