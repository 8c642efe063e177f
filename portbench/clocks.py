"""What the program measures of itself (``fv3net_tpu_torch.tracing``,
FV3's routine clocks): the device spans of its dt, its tally of
exchanges and its host spans of set-up.  The module is found among the
modules the run loaded, as ``harness.launch_counts`` finds the launch
counters; each reader returns None where the program has no such module
(a checkout before it) or it holds nothing to read."""

import statistics
import sys


def _tracing():
    return sys.modules.get("fv3net_tpu_torch.tracing")


def stage_ms(name: str):
    """The median, over every complete ``dycore.dt`` in the program's log
    of device spans (the warm-up's, the window's, the traced stretch's
    and the check's dts), of the self ms of the span `name` in it (its
    duration less what its child spans cover)."""
    tracing = _tracing()
    if tracing is None:
        return None
    steps = tracing.per_step().get(name)
    return statistics.median(steps) if steps else None


def exchange_mb():
    """MB (1e6 bytes) that the single-process exchanges write a dt on the
    card: the tally's bytes of every exchange over its count of
    ``dycore.dt`` spans, both moved by each replay as its capture moved
    them (neither counts the capture's warm-up)."""
    tracing = _tracing()
    if tracing is None:
        return None
    dts = tracing.COUNTS.calls("dycore.dt")
    if not dts:
        return None
    return sum(tracing.COUNTS.nbytes(k) for k in tracing.EXCHANGES) / (
        dts * 1e6)


def host_s(*names: str):
    """Seconds of the program's host spans `names`, every sample summed."""
    tracing = _tracing()
    if tracing is None:
        return None
    got = [t for k in names for t in tracing.HOST.times.get(k, ())]
    return sum(got) if got else None
