"""What the program measures of its coupled step
(``fv3net_tpu_torch.tracing``): the device spans inside each
``step.coupled``.  The module
is found among the modules the run loaded, as ``clocks.py`` finds it;
each reader returns None where the program has no such module or span
(a checkout before the coupled step had them) or the log holds no
complete coupled step."""

import statistics
import sys

OUTER = "step.coupled"


def _tracing():
    return sys.modules.get("fv3net_tpu_torch.tracing")


def step_ms(name: str):
    """The median, over every complete ``step.coupled`` in the program's
    log of device spans, of the ms of the spans `name` inside it,
    children included (the outer span's own duration for `name` =
    ``OUTER``)."""
    tracing = _tracing()
    if tracing is None or OUTER not in tracing.SPANS:
        return None
    spans = tracing.device_spans(OUTER)
    steps = sum(s.name == OUTER for s in spans)
    totals, seen = [0.0] * steps, False
    for s in spans:
        if s.name == name and s.step is not None:
            totals[s.step] += s.ms
            seen = True
    return statistics.median(totals) if seen else None

