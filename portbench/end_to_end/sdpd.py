"""Simulated days a wall day: the simulated seconds of every step
completed in the window over the window's wall seconds."""

from portbench.window import sdpd


def read(ctx):
    return sdpd(ctx.window, ctx.dt_seconds)
