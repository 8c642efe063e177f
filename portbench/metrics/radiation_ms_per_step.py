"""Physics: ms a coupled step of gray radiation and its heating (the
program's device span ``physics.radiation``), the median over the
coupled steps of the program's log."""

from portbench.coupled_clocks import step_ms


def read(ctx):
    return step_ms("physics.radiation")
