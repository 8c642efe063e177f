"""Physics: ms a coupled step of its physics stage (the program's device
span ``step.physics``: gray radiation, the GFS-style suite and the
Monitor), the median over the coupled steps of the program's log."""

from portbench.coupled_clocks import step_ms


def read(ctx):
    return step_ms("step.physics")
