"""Set-up: seconds the program takes to build the stepper's grid and metrics
(its host spans ``setup.grid``, ``CubedSphereGrid.make``, and
``setup.metrics``, ``SWMetrics.make``)."""

from portbench.clocks import host_s


def read(ctx):
    return host_s("setup.grid", "setup.metrics")
