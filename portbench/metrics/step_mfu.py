"""The whole step: the configuration's operation count of one step
(``step_ops``, counted by ``portbench/opcount.py`` over the plain
reference), times the steps of the untraced window, over the window's
seconds and the card's float32 rate outside the tensor cores (%)."""

from portbench.roofline import F32_OPS_PER_S


def read(ctx):
    ops = ctx.cfg.get("step_ops")
    if not ops or not ctx.window.steps:
        return None
    rate = ops * ctx.window.steps / ctx.window.elapsed_s
    return 100.0 * rate / (F32_OPS_PER_S * ctx.chips)
