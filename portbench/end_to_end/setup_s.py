"""From process start to the end of the warm-up: imports, the program's
build (kernel library, metrics, stepper), the inputs, the capture and
the warm-up replays.  The card's idle wait after it, until the window
may open (``harness.OPEN_AT_S``), is the harness's and is left out."""


def read(ctx):
    return ctx.setup_s
