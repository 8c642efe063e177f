"""Device: the share (%) of the traced window in which no device op
runs (1 - the union of the device ops' intervals over the window)."""


def read(ctx):
    if not ctx.trace.ops or ctx.trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
