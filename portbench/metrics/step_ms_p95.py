"""The 95th percentile of every step's device time in the untraced
window (CUDA events before and after each step, no synchronisation
inside).  A per-layer metric, not an end-to-end one: in about one window
in thirteen the card's slow first seconds of a process (PERF.md, section
2) still reach into the window and lift it 5%."""

from portbench.window import p95


def read(ctx):
    return p95(ctx.window.step_ms)
