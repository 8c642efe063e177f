"""Dispatch layer (``graphs.Graphed`` replay behind the cell's entry):
the host clock around the program's call, in ms per step, the mean over
every step of the untraced window (no synchronisation inside)."""

import statistics


def read(ctx):
    if not ctx.window.host_ms:
        return None
    return statistics.fmean(ctx.window.host_ms)
