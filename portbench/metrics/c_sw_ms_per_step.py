"""Operators and exchanges: ms a dt of the C-grid half-stage, FV3's c_sw
(the program's device span ``dycore.c_sw``: a substep's shared
exchanges and ``_c_sw_half_3d``), self time summed over the dt's
substeps, the median over the dts of the program's log."""

from portbench.clocks import stage_ms


def read(ctx):
    return stage_ms("dycore.c_sw")
