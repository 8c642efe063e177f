"""Physics: ms a coupled step of the surface exchange and the PBL's
vertical diffusion, four tridiagonal solves over the levels (the
program's device span ``physics.pbl``), the median over the coupled
steps of the program's log."""

from portbench.coupled_clocks import step_ms


def read(ctx):
    return step_ms("physics.pbl")
