"""Physics: ms a coupled step of the GFDL microphysics, its three
sedimentations recurrences over the levels (the program's device span
``physics.microphysics``), the median over the coupled steps of the
program's log."""

from portbench.coupled_clocks import step_ms


def read(ctx):
    return step_ms("physics.microphysics")
