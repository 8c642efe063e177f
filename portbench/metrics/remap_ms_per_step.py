"""Operators and exchanges: ms a dt of the vertical remap, FV3's
Lagrangian-to-Eulerian remap (the program's device span ``dycore.remap``,
``remap_step``), the median over the dts of the program's log."""

from portbench.clocks import stage_ms


def read(ctx):
    return stage_ms("dycore.remap")
