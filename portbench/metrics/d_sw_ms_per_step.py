"""Operators and exchanges: ms a dt of the D stage, FV3's d_sw (the
program's device span ``dycore.d_sw``, a substep's ``_substep_core``,
less its Riemann solver and damping spans: the transports, the filters
and the wind update), summed over the dt's substeps, the median over the
dts of the program's log."""

from portbench.clocks import stage_ms


def read(ctx):
    return stage_ms("dycore.d_sw")
