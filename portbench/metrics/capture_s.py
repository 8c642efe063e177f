"""Dispatch: seconds of the program's capture of the cell's graph, its
eager warm-up calls and the capture itself (its host spans
``graphs.warmup`` and ``graphs.capture``; the cell captures one graph)."""

from portbench.clocks import host_s


def read(ctx):
    return host_s("graphs.warmup", "graphs.capture")
