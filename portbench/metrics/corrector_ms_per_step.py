"""ML corrector: ms a coupled step of its postphysics stage (the
program's device span ``step.postphysics``: the dense model's
``pure_fn``, the limiter and the mass-conserving set), the median over
the coupled steps of the program's log."""

from portbench.coupled_clocks import step_ms


def read(ctx):
    return step_ms("step.postphysics")
