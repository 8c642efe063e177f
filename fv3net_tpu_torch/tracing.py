"""FV3's per-routine clocks in the port: device spans that survive a
CUDA-graph capture, host spans of set-up, and a tally of exchanges.

FV3 runs with its routine clocks always on (``mpp_clock`` around c_sw,
d_sw, Riem_Solver, tracer_2d and the remap).  The port's dt is one
replayed CUDA graph (``graphs.Graphed``): no Python of the dt runs at
replay, so no host clock can enclose its stages.  Three parts:

* **Device spans.**  ``span(name, like)`` launches a begin mark and an
  end mark, one-thread kernels (``csrc/mark.cu``, ``fv3_mark<id>`` in a
  profiler trace), on the current stream when `like` is a CUDA tensor.
  Each appends (id, the card's global timer in ns) to one log on the
  card.  A capture records the marks into its graph, so every replay
  writes its own stamps: each dt gets its stages without a host call
  and without the profiler.  The spans are always on (FV3's practice);
  a span fires only where ``WRITERS`` holds a writer for its tensor's
  device type (``ops._build`` gives the card's), so it does nothing on
  CPU tensors, and it does nothing while a predicate given to
  ``mute_while`` holds: ``grid.halo``'s mesh of shards, whose streams
  would interleave one log.  The names are ``SPANS``: the name of index i
  marks its begin with id 2i and its end with id 2i + 1.  The log is
  allocated at the first mark made outside a capture (a ``Graphed``
  warm-up always makes one first); a mark made in a capture before the
  log exists raises.  It holds ``CAPACITY`` entries, overwritten
  oldest first.  ``device_spans()`` synchronises once, reads and
  decodes it; ``per_step()`` gives each span's self time (its duration
  less its children's) in every ``dycore.dt`` (or in every
  ``step.coupled``, the coupled step of ``runtime/compiled_loop.py``,
  whose stages hold the dt, gray radiation, the suite's PBL, convection
  and microphysics, and the ML corrector); ``dropped()`` counts the
  entries a wrapped log lost; ``reset()`` empties it.
* **The device trace's clock.**  The marks are device ops, so a
  ``torch.profiler`` trace holds them at their own time:
  ``attribute(ops)`` assigns each op of a trace to the innermost span
  open at its start, and ``align(ops)`` gives the offset between the
  log's stamps and the trace's clock.
* **Host spans and counts.**  ``host_span(name)`` is a
  ``record_function`` (the profiler's clock) around a clock of the
  process-wide ``HOST`` timer (``Timer``; ``runtime.timing`` reports it
  under ``host:<name>``): the set-up's phases (``setup.grid``,
  ``setup.metrics``, ``setup.kernels``, ``graphs.warmup``,
  ``graphs.capture``) and the coupled loop's host work a step
  (``loop.astronomy``, ``loop.upload``).  ``COUNTS`` tallies calls and
  bytes by name and device type: the single-process exchanges of
  ``grid/halo.py`` (``EXCHANGES``), the ``STEP`` spans that fired, the
  dts the bytes are divided by, and the bytes the coupled loop copies
  from the host to the device a step (``loop.h2d``).  A capture records
  what its body added and each replay adds it again (``recorded``, as
  ``ops._build.COUNTED``'s launches), so the tally costs nothing at
  replay.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import re
import threading
import time as _time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

# the device spans, FV3's routine names: index i marks with ids 2i, 2i+1
SPANS = (
    "dycore.dt", "dycore.c_sw", "dycore.d_sw", "dycore.riem_solver",
    "dycore.damping", "dycore.tracer_2d", "dycore.remap",
    "step.dynamics", "step.physics", "step.postphysics",
    "step.coupled", "physics.radiation", "physics.pbl",
    "physics.convection", "physics.microphysics", "postphysics.ml",
)
_INDEX = {name: i for i, name in enumerate(SPANS)}
# the span of one dycore dt: the steps of per_step, counted in COUNTS
STEP = "dycore.dt"
# log entries, (id, ns) of 16 bytes each: 1 MiB, ~1200 dts of 54 marks
# or ~900 coupled steps of 72
CAPACITY = 65536
# the writer of one mark by device type, (log, mark id) -> None: spans
# fire on tensors of these types only (ops._build gives the card's)
WRITERS: Dict[str, Callable[[torch.Tensor, int], None]] = {}
# predicates while any of which no span fires (mute_while)
_MUTED: List[Callable[[], bool]] = []
# the single-process exchanges of grid/halo.py that COUNTS tallies
EXCHANGES = (
    "halo_exchange", "halo_exchange_dgrid", "halo_exchange_cgrid",
    "canonicalize_cgrid_boundary", "average_dgrid_boundary",
)
# attribute()'s key of the ops no span encloses
OUTSIDE = "(no span)"
_MARK = re.compile(r"fv3_mark<(\d+)>")


class Timer:
    """Accumulate wall-clock samples per named block
    (pace.util.Timer role).  The clock is the host's: around GPU work it
    measures enqueue time unless the block ends in a synchronisation."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def clock(self, name: str):
        t0 = _time.perf_counter()
        try:
            yield
        finally:
            self.times.setdefault(name, []).append(
                _time.perf_counter() - t0
            )

    def reset(self):
        self.times = {}


# the set-up's host spans of this process
HOST = Timer()


@contextlib.contextmanager
def host_span(name: str):
    """The block as a profiler range and a sample of ``HOST``'s clock
    `name`."""
    with record_function(name), HOST.clock(name):
        yield


class Tally:
    """Calls and bytes by (name, device type), under a lock: the shards
    of a local mesh count from threads of their own."""

    def __init__(self):
        self.counts: Dict[Tuple[str, str], List[int]] = {}
        self._lock = threading.Lock()

    def add(self, name: str, device_type: str, nbytes: int = 0,
            calls: int = 1):
        with self._lock:
            c = self.counts.setdefault((name, device_type), [0, 0])
            c[0] += calls
            c[1] += nbytes

    def snapshot(self) -> dict:
        with self._lock:
            return {k: tuple(v) for k, v in self.counts.items()}

    def restore(self, snap: dict):
        with self._lock:
            self.counts = {k: list(v) for k, v in snap.items()}

    def since(self, snap: dict) -> dict:
        """What was added after `snap`: {key: (calls, bytes)}."""
        with self._lock:
            out = {}
            for k, (c, b) in self.counts.items():
                c0, b0 = snap.get(k, (0, 0))
                if (c, b) != (c0, b0):
                    out[k] = (c - c0, b - b0)
            return out

    def replay(self, added: dict, times: int = 1):
        """Add `added` (``since``'s form) `times` times."""
        with self._lock:
            for key, (c, b) in added.items():
                now = self.counts.setdefault(key, [0, 0])
                now[0] += c * times
                now[1] += b * times

    def calls(self, name: str, device_type: str = "cuda") -> int:
        return self.counts.get((name, device_type), (0, 0))[0]

    def nbytes(self, name: str, device_type: str = "cuda") -> int:
        return self.counts.get((name, device_type), (0, 0))[1]


COUNTS = Tally()


@contextlib.contextmanager
def recorded():
    """Yield a dict that holds, once the block ends, what the block added
    to ``COUNTS`` (``Tally.since``); ``COUNTS`` is then put back as it
    was before the block.  A capture's body runs inside it, and each
    replay adds the dict (``COUNTS.replay``)."""
    snap = COUNTS.snapshot()
    added = {}
    try:
        yield added
    finally:
        added.update(COUNTS.since(snap))
        COUNTS.restore(snap)


def exchanged(name: str, *outs: torch.Tensor):
    """One call of the exchange `name`, which wrote the tensors `outs`:
    each exchange is one gather over its whole padded output (halo and
    pass-through), so those are the bytes it writes."""
    COUNTS.add(name, outs[0].device.type,
               sum(o.numel() * o.element_size() for o in outs))


# --- the device log ------------------------------------------------------

# [capacity + 1, 2] int64 on the card: row 0 holds the cursor (entries
# written so far), row 1 + k entry k modulo the capacity: (id, ns)
_log: Optional[torch.Tensor] = None
_decoded = None  # (key, spans) of the last read


def mute_while(predicate: Callable[[], bool]):
    """Let no span fire while `predicate()` holds (``grid.halo`` gives
    its mesh of shards: shards on several streams would interleave one
    log)."""
    _MUTED.append(predicate)


def _fires(like) -> bool:
    return (isinstance(like, torch.Tensor) and like.device.type in WRITERS
            and not any(muted() for muted in _MUTED))


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _mark(mark_id: int, device: torch.device):
    global _log
    if _log is None:
        if _capturing(device):
            raise RuntimeError(
                "a device span inside a capture before the log exists: "
                "make one mark outside a capture first (a Graphed warm-up "
                "does)")
        _log = torch.zeros((CAPACITY + 1, 2), dtype=torch.int64,
                           device=device)
    elif _log.device != device:
        raise ValueError(f"the span log lives on {_log.device}, not on "
                         f"{device}")
    WRITERS[device.type](_log, mark_id)


@contextlib.contextmanager
def span(name: str, like):
    """The block as a device span `name` (one of ``SPANS``) on the stream
    of `like`'s device, and for ``STEP`` one call of it in ``COUNTS``;
    nothing where `like` is no tensor of a type in ``WRITERS`` or a
    muting predicate holds.  A block that raises leaves its span open,
    and the decoder drops it."""
    if name not in _INDEX:
        raise ValueError(f"{name!r} is none of tracing.SPANS")
    if not _fires(like):
        yield
        return
    i = _INDEX[name]
    _mark(2 * i, like.device)
    if name == STEP:
        COUNTS.add(name, like.device.type)
    yield
    _mark(2 * i + 1, like.device)


def reset():
    """Empty the log (in place: captured graphs keep its address)."""
    global _decoded
    if _log is not None:
        _log.zero_()
    _decoded = None


def _read() -> Optional[np.ndarray]:
    """The log on the host, after one synchronisation of its device."""
    if _log is None:
        return None
    if _log.device.type == "cuda":
        torch.cuda.synchronize(_log.device)
    return _log.cpu().numpy()


def dropped() -> int:
    """The entries a wrapped log has overwritten since it was emptied."""
    buf = _read()
    return 0 if buf is None else max(0, int(buf[0, 0]) - (buf.shape[0] - 1))


def entries() -> List[Tuple[int, int]]:
    """The log's entries (id, ns), oldest first, after one
    synchronisation of its device."""
    buf = _read()
    if buf is None:
        return []
    cursor, cap = int(buf[0, 0]), buf.shape[0] - 1
    rows = buf[1:]
    if cursor > cap:
        k = cursor % cap
        rows = np.concatenate([rows[k:], rows[:k]])
    else:
        rows = rows[:cursor]
    return [(int(i), int(t)) for i, t in rows]


@dataclasses.dataclass(frozen=True)
class Span:
    """One device span: times in ns of the card's global timer; parent
    and step index the list ``decode`` returns: the enclosing span and
    the enclosing `outer` span, or None."""

    name: str
    start: int
    end: int
    parent: Optional[int]
    step: Optional[int]

    @property
    def ms(self) -> float:
        return (self.end - self.start) / 1e6


def _open(stack, name) -> Optional[int]:
    """The depth of the innermost open span `name` in `stack`, or None."""
    return next((k for k in range(len(stack) - 1, -1, -1)
                 if stack[k][0] == name), None)


def decode(log_entries, outer: str = STEP) -> List[Span]:
    """The complete spans of `log_entries` (id, ns), in order of their
    begin.  A span whose begin is missing (overwritten in a wrapped log)
    or whose end is missing (the log read mid-span, a body that raised)
    is dropped with everything inside it: no span nests in one of its
    own name, so a begin of a name still open ends what that open one
    holds.  `step`: the index of the enclosing `outer` span among the
    `outer` spans (its own for one)."""
    roots, stack = [], []  # nodes: [name, start, end, children]
    for mark_id, t in log_entries:
        if mark_id // 2 >= len(SPANS):
            raise ValueError(f"mark id {mark_id} names no span")
        name = SPANS[mark_id // 2]
        depth = _open(stack, name)
        if mark_id % 2 == 0:
            if depth is not None:  # left open by a body that raised
                del stack[depth:]
            stack.append([name, t, None, []])
            continue
        if depth is None:
            # everything before lies inside a span whose begin is lost
            roots, stack = [], []
            continue
        del stack[depth + 1:]  # left open inside it: dropped
        node = stack.pop()
        node[2] = t
        (stack[-1][3] if stack else roots).append(node)
    out: List[Span] = []
    steps = [0]

    def walk(node, parent, step):
        name, start, end, children = node
        if name == outer:
            step = steps[0]
            steps[0] += 1
        out.append(Span(name, start, end, parent, step))
        here = len(out) - 1
        for child in children:
            walk(child, here, step)

    for node in roots:
        walk(node, None, None)
    return out


def device_spans(outer: str = STEP) -> List[Span]:
    """The log's complete spans (``decode``), read once per new entry."""
    global _decoded
    log_entries = entries()
    key = (len(log_entries), log_entries[-1] if log_entries else None,
           outer)
    if _decoded is None or _decoded[0] != key:
        _decoded = (key, decode(log_entries, outer))
    return _decoded[1]


def per_step(outer: str = STEP, spans=None) -> Dict[str, List[float]]:
    """For each span name, its self ms (its duration less its children's)
    summed over each `outer` span: one value for each complete `outer`
    span, in order (0 where the name does not occur in it).  `spans`:
    ``decode``'s list (default: the log's)."""
    spans = device_spans(outer) if spans is None else spans
    n_steps = sum(s.name == outer for s in spans)
    inner = [0] * len(spans)
    for s in spans:
        if s.parent is not None:
            inner[s.parent] += s.end - s.start
    out: Dict[str, List[float]] = {}
    for s, ns in zip(spans, inner):
        if s.step is not None:
            out.setdefault(s.name, [0.0] * n_steps)[s.step] += (
                s.end - s.start - ns) / 1e6
    return out


def mark_of(op_name: str) -> Optional[int]:
    """The mark id of a device op's name, or None for other ops."""
    m = _MARK.search(op_name)
    return int(m.group(1)) if m else None


def attribute(ops) -> Dict[str, Dict[str, float]]:
    """{span: {op name: seconds}} of the device ops `ops` (name, start,
    end in us, as ``portbench.trace.Trace.ops``): each op goes to the
    innermost span open at its start, by the ``fv3_mark<id>`` ops among
    them (each mark to the span it opens or closes); ops outside every
    span to ``OUTSIDE``."""
    out = collections.defaultdict(lambda: collections.defaultdict(float))
    stack = []
    for name, a, b in sorted(ops, key=lambda op: (op[1], op[2])):
        mark_id = mark_of(name)
        if mark_id is not None and mark_id % 2 == 0:
            stack.append(SPANS[mark_id // 2])
        where = stack[-1] if stack else OUTSIDE
        out[where][name] += (b - a) / 1e6
        if mark_id is not None and mark_id % 2 == 1:
            span_name = SPANS[mark_id // 2]
            if span_name in stack:
                del stack[len(stack) - 1 - stack[::-1].index(span_name):]
    return {k: dict(v) for k, v in out.items()}


def align(ops, log_entries=None) -> float:
    """The ns to add to a log stamp to place it on the clock of the trace
    whose device ops are `ops` (start and end in us): the stretch of the
    log (default: the log's entries) whose ids are the trace's marks in
    order and whose stamps keep the steadiest distance to the marks'
    starts; the median of those distances."""
    marks = sorted((a, mark_of(name)) for name, a, _ in ops
                   if mark_of(name) is not None)
    if not marks:
        raise ValueError("the trace holds no marks")
    log_entries = entries() if log_entries is None else log_entries
    ids = np.array([i for i, _ in log_entries], dtype=np.int64)
    stamps = np.array([t for _, t in log_entries], dtype=np.int64)
    want = np.array([i for _, i in marks], dtype=np.int64)
    at = np.array([a for a, _ in marks], dtype=np.float64) * 1e3
    m = len(want)
    best = None
    for k in np.nonzero(ids[: len(ids) - m + 1] == want[0])[0]:
        if not np.array_equal(ids[k:k + m], want):
            continue
        gap = at - (stamps[k:k + m] - stamps[k]).astype(np.float64)
        spread = gap.max() - gap.min()
        if best is None or spread < best[0]:
            best = (spread, float(np.median(gap)) - float(stamps[k]))
    if best is None:
        raise ValueError("the trace's marks are not in the log")
    return best[1]
