"""Operators and exchanges: MB a dt that the program's single-process halo
exchanges, staggered exchanges and boundary fixes write on the card
(its tally of calls and bytes, moved by each replay of the graph as its
capture moved it, over its count of dts)."""

from portbench.clocks import exchange_mb


def read(ctx):
    return exchange_mb()
