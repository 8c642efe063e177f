"""One step captured as a CUDA graph and replayed: the port's
counterpart of ``jax.jit`` with ``donate_argnums``.

The JAX package compiles its dycore ``run`` (a ``lax.scan`` of
``one_dt``) and its coupled step into one device program each
(``fv3net_tpu/dycore/hydro.py:846-866``,
``fv3net_tpu/runtime/compiled_loop.py:279-285``).  Eager torch issues
one Python call per device op instead; at C48 that host work is longer
than the device's.  ``Graphed`` records a step's device work once and
replays it with one launch:

* the arguments are a tree of tuples (NamedTuples too), lists, dicts,
  None, tensors and Python constants.  Every tensor is copied into a
  static buffer the graph reads (in the first call's layout); a constant
  is baked into the graph;
* before the capture the step runs ``WARMUP`` times eagerly on a side
  stream, so that every table cached on a first call (the exchanges'
  gather tables, the kernels' shared-memory attributes, the ML scalers)
  is built outside the graph; then the capture on that stream;
* a graph is kept for each key: the tree's structure, each tensor's
  shape, dtype and device, the constants, and what ``key()`` returns
  (state the step reads at capture time, e.g. the fused-transport
  switch);
* ``carry`` names the part of the output that is the next value of the
  first argument.  The graph ends by copying it into the first
  argument's buffers, so ``steps`` replays chain as a scan does;
* ``donate=True``: the first argument's buffers are the caller's own
  tensors (where each is dense and none shares memory) and the carried
  output is returned in them: a chain ``f(f(s))`` copies no state.
  Like a donated JAX buffer, the input is consumed, and the result is
  valid until the next call with arguments of the same key.  With
  ``donate=False`` the caller's tensors are never written and every
  output is a fresh tensor;
* every other output is cloned after the replay, so a result the
  caller keeps is never overwritten by the next replay;
* the kernels' launch counters (``<wrapper>.launches`` of every wrapper
  in ``ops._build.COUNTED``) and the tally of exchanges and device spans
  (``tracing.COUNTS``) move only for work on the device: the warm-up's
  and the capture's Python calls are taken back, and each replay adds
  the counts the capture recorded;
* the warm-up and the capture are the host spans ``graphs.warmup`` and
  ``graphs.capture`` (``tracing.host_span``).

Only CUDA tensors are captured; a capture that fails raises, and
nothing falls back to eager.  The CPU path of the callers stays eager.

``jit(fn)`` is the port's ``jax.jit(fn)`` for the smaller units the JAX
package jits one by one (the wrapper's physics, the radiation drivers,
the ML predictors' apply): the eager ``fn`` on CPU tensors, a
``Graphed`` replay on CUDA tensors, and ``fn`` inlined where it is
called inside another capture (or its warm-up), as a jit inside a jit.
Keyword arguments, hashable frozen dataclasses (a static configuration,
``static_argnames``) and Python constants join the key.  A unit keeps at
most ``MAX_CAPTURES`` graphs: a call with a new key beyond that drops the
least recently used one, and says so in a warning (``_LOG``), so a caller
that cycles through more shapes recaptures rather than holding pool
memory without bound.  ``captures()`` and ``memory()`` tell how many
graphs a unit holds and the device bytes they keep; ``units()`` lists
the live units.

``jit(fn, updates=True)`` is the port's jitted training step (each fit
family's ``@jax.jit`` step with its optax update): ``fn`` updates in
place state that is none of its arguments (the parameters, their
gradients, the optimizer's state), so a key's first ``WARMUP`` calls
are the caller's own calls, run eagerly on the side stream, in place of
the warm-up on the buffers; the next call captures without a warm-up
and replays, and the sequence of updates is eager's, call for call.

``eager()`` is the other side of an A/B measurement: within it every
``jit`` unit and every ``Graphed`` function runs its eager body on CUDA
tensors too.  Nothing enters it by itself.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import logging
import weakref
from typing import Callable, Optional, Union

import numpy as np
import torch

from . import tracing
from .ops._build import COUNTED

_LOG = logging.getLogger(__name__)

# eager calls before a capture: the first builds the cached tables, the
# second runs as the capture will, with every table in place
WARMUP = 2
# the graphs a jit unit keeps (least recently used dropped beyond it):
# a predictor sees a batch shape or two (the offline evaluation: its
# dataset's and the column Jacobian's), the physics one key per config
MAX_CAPTURES = 8

# the device type whose tensors are captured
CAPTURED_DEVICE = "cuda"
# > 0 while a Graphed function's body runs its warm-up or its capture
_inside = 0
# set within eager(): every body runs eagerly
_eager = False


@contextlib.contextmanager
def eager():
    """Within the block every ``jit`` unit and every ``Graphed`` function
    runs its eager body, on CUDA tensors too (the eager side of an A/B
    measurement)."""
    global _eager
    before, _eager = _eager, True
    try:
        yield
    finally:
        _eager = before


def _static(x):
    """x is a constant of the key: a hashable frozen dataclass."""
    if not (dataclasses.is_dataclass(x) and not isinstance(x, type)
            and type(x).__dataclass_params__.frozen):
        return False
    try:
        hash(x)
    except TypeError:
        return False
    return True


def _spec(x, leaves):
    """Hashable description of the tree x; its tensors appended to
    `leaves` in order."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return ("T", tuple(x.shape), x.dtype, x.device)
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return ("S", type(x), tuple(_spec(v, leaves) for v in x))
    if isinstance(x, dict):
        return ("D", tuple((k, _spec(v, leaves)) for k, v in x.items()))
    if isinstance(x, (bool, int, float, str)) or _static(x):
        return ("C", type(x), x)
    raise TypeError(f"cannot capture an argument of type {type(x)}")


def _build(spec, leaves):
    """The tree of `spec` with its tensors taken from the iterator
    `leaves`."""
    if spec is None:
        return None
    tag = spec[0]
    if tag == "T":
        return next(leaves)
    if tag == "C":
        return spec[2]
    if tag == "D":
        return {k: _build(s, leaves) for k, s in spec[1]}
    typ, items = spec[1], [_build(s, leaves) for s in spec[2]]
    if hasattr(typ, "_fields"):  # a NamedTuple
        return typ(*items)
    return typ(items)


def _flatten(x):
    leaves = []
    return leaves, _spec(x, leaves)


def _storages(tensors):
    return [t.untyped_storage().data_ptr() for t in tensors]


def _dense(t):
    """No two elements of t share memory and none is skipped (any order
    of its axes): a buffer the graph may write in place."""
    expect = 1
    for stride, size in sorted(
            (st, sz) for st, sz in zip(t.stride(), t.shape) if sz > 1):
        if stride != expect:
            return False
        expect *= size
    return True


def _buffer(t):
    """A static buffer holding a copy of `t`, in `t`'s layout (its strides
    where it is dense): the captured kernels are those an eager call on
    `t` runs (a convolution on a channels-last view runs other cuDNN
    plans than on a contiguous one, and rounds otherwise)."""
    return torch.empty_like(t, memory_format=torch.preserve_format).copy_(t)


_SIDE = {}  # device -> the stream of its warm-ups and captures


def _side(dev):
    """The side stream of `dev`'s warm-ups and captures (one, so that a
    real call taken before a capture runs on the capture's stream)."""
    if dev not in _SIDE:
        _SIDE[dev] = torch.cuda.Stream(dev)
    return _SIDE[dev]


def _real_call(fn, args, dev):
    """``fn(*args)`` eagerly, as a capture's body runs: on the side stream
    of `dev` (a CUDA device; another device type, a stand-in capture's,
    has no streams), the jit units inside it inlined.  Its output is read
    on the current stream; what else it frees the side stream reuses
    only after the current stream's work queued by then, since every use
    of the side stream starts by waiting for it."""
    global _inside
    _inside += 1
    try:
        if dev.type != "cuda":
            return fn(*args)
        side, current = _side(dev), torch.cuda.current_stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = fn(*args)
        current.wait_stream(side)
        for t in _tensors(out):
            t.record_stream(current)
        return out
    finally:
        _inside -= 1


class _Capture:
    """One graph: its static buffers, its outputs and its counts."""

    def __init__(self, fn, args, leaves, spec, carry, donate,
                 warmup=WARMUP, capture_error_mode="global"):
        dev = leaves[0].device
        n_first = len(_flatten(args[0])[0]) if carry is not None else 0
        first = leaves[:n_first]
        adopt = (
            donate and all(_dense(t) for t in first)
            and len(set(_storages(first))) == n_first
            and not set(_storages(first)) & set(_storages(leaves[n_first:]))
        )
        self.static = [
            t if adopt and i < n_first else _buffer(t)
            for i, t in enumerate(leaves)
        ]
        self.n_first = n_first
        self.first_spec = spec[2][0]
        self.carry = carry
        self.donate = donate
        s_args = _build(spec, iter(self.static))
        self.static_bytes = sum(
            t.numel() * t.element_size() for i, t in enumerate(self.static)
            if not (adopt and i < n_first))
        # a wrapper registered during the warm-up (its module imported
        # there) starts from 0
        before = {w: w.launches for w in COUNTED.values()}
        side = _side(dev)
        global _inside
        _inside += 1
        try:
            side.wait_stream(torch.cuda.current_stream(dev))
            with tracing.host_span("graphs.warmup"), tracing.recorded(), \
                    torch.cuda.stream(side):
                for _ in range(warmup):
                    fn(*s_args)
            torch.cuda.current_stream(dev).wait_stream(side)
            before = {w: before.get(w, 0) for w in COUNTED.values()}
            for w, b in before.items():
                w.launches = b
            self.graph = torch.cuda.CUDAGraph()
            with tracing.host_span("graphs.capture"), \
                    tracing.recorded() as self.tally, \
                    torch.cuda.graph(self.graph, stream=side,
                                     capture_error_mode=capture_error_mode):
                # read after the context has emptied the allocator's
                # cache: the graph's private pool takes new segments
                reserved = torch.cuda.memory_reserved(dev)
                out = fn(*s_args)
                if carry is not None:
                    self._write_back(out)
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
            self.counts = {w: w.launches - b for w, b in before.items()
                           if w.launches != b}
        finally:
            _inside -= 1
            for w in COUNTED.values():
                w.launches = before.get(w, 0)
        # the outputs' pool tensors, read after every replay
        if carry is None or carry == "all":
            self.out_type, self.parts = None, [_flatten(out)]
        else:
            self.out_type, self.parts = type(out), [_flatten(o) for o in out]

    def _write_back(self, out):
        """In the graph: the carried output into the first argument's
        buffers."""
        new, new_spec = _flatten(out if self.carry == "all"
                                 else out[self.carry])
        if new_spec != self.first_spec:
            raise ValueError(
                "the carried output does not match the first argument: "
                f"{new_spec} against {self.first_spec}"
            )
        for dst, src in zip(self.static, new):
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src)

    def __call__(self, leaves, steps):
        for dst, src in zip(self.static, leaves):
            if src is not dst and not (src.data_ptr() == dst.data_ptr()
                                       and src.stride() == dst.stride()):
                dst.copy_(src)
        for _ in range(steps):
            self.graph.replay()
            for w, c in self.counts.items():
                w.launches += c
        tracing.COUNTS.replay(self.tally, steps)
        if self.carry is None:
            (out_leaves, out_spec), = self.parts
            return _build(out_spec, (t.clone() for t in out_leaves))
        first = self.static[: self.n_first]
        carried = _build(self.first_spec, iter(
            first if self.donate else [t.clone() for t in first]))
        if self.carry == "all":
            return carried
        items = [
            carried if i == self.carry
            else _build(s, (t.clone() for t in part))
            for i, (part, s) in enumerate(self.parts)
        ]
        if hasattr(self.out_type, "_fields"):
            return self.out_type(*items)
        return self.out_type(items)


class Graphed:
    """``fn(*args, **kwargs)`` on CUDA tensors, captured once per key and
    replayed.

    carry: None, "all" (the whole output is the next first argument) or
    the index of that part in a tuple output.  donate: the first
    argument is consumed and the carried output returned in its buffers
    (needs carry).  key: a function of no arguments whose value joins
    the cache key.  max_captures: the keys kept (None: no bound); a new
    key beyond it drops the least recently used, with a warning.
    updates: fn updates in place state that is none of its arguments (a
    training step; no carry): a key's first WARMUP calls are real calls
    (``_real_call``) and its capture warms up nothing, so the state sees
    every call once, in order.  ``captures`` maps each key to its
    capture, or, before it, to the real calls taken.
    capture_error_mode: ``torch.cuda.graph``'s; "thread_local" where other
    threads launch and allocate into the capture (a local mesh's shards,
    ``parallel/spmd_dycore.py``), which "global" refuses.
    """

    def __init__(self, fn: Callable, *, carry: Optional[Union[str, int]] =
                 None, donate: bool = False,
                 key: Callable[[], tuple] = tuple,
                 max_captures: Optional[int] = None, updates: bool = False,
                 capture_error_mode: str = "global"):
        if donate and carry is None:
            raise ValueError("donate needs carry: the output it aliases")
        if updates and carry is not None:
            raise ValueError("updates takes no carry: its state is none of "
                             "its arguments")
        self.fn = fn
        self.carry = carry
        self.donate = donate
        self.key = key
        self.max_captures = max_captures
        self.updates = updates
        self.capture_error_mode = capture_error_mode
        self.captures = collections.OrderedDict()

    def _with_kwargs(self, *args):
        return self.fn(*args[:-1], **args[-1])

    def __call__(self, *args, steps: int = 1, **kwargs):
        if steps != 1 and self.carry != "all":
            raise ValueError("steps != 1 needs carry=\"all\"")
        if _eager:
            if steps == 1:
                return self.fn(*args, **kwargs)
            out = args[0]
            for _ in range(steps):
                out = self.fn(out, *args[1:], **kwargs)
            return out
        fn = self.fn
        if kwargs:  # a trailing dict of the keyword arguments, in order
            args = args + (dict(sorted(kwargs.items())),)
            fn = self._with_kwargs
        leaves, spec = _flatten(args)
        if not leaves or any(t.device.type != CAPTURED_DEVICE
                             for t in leaves):
            raise ValueError("Graphed steps take CUDA tensors only")
        if len({t.device for t in leaves}) != 1:
            raise ValueError("Graphed steps take tensors on one device")
        if any(t.requires_grad for t in leaves):
            raise ValueError(
                "a replayed graph is not differentiable: differentiate "
                "the eager step instead"
            )
        if steps == 0:
            return args[0]
        key = (spec, bool(kwargs), self.key())
        cap = self.captures.get(key)
        if cap is None:
            if (self.max_captures is not None
                    and len(self.captures) >= self.max_captures):
                self.captures.popitem(last=False)
                _LOG.warning(
                    "%s holds %d keys, its bound: the least recently "
                    "used is dropped for a new key",
                    getattr(self.fn, "__qualname__", self.fn),
                    self.max_captures)
            cap = 0
        else:
            self.captures.move_to_end(key)
        if isinstance(cap, int):  # not captured yet: the real calls taken
            if self.updates and cap < WARMUP:
                self.captures[key] = cap + 1
                return _real_call(fn, args, leaves[0].device)
            opts = {"warmup": 0} if self.updates else {}
            if self.capture_error_mode != "global":
                opts["capture_error_mode"] = self.capture_error_mode
            cap = self.captures[key] = _Capture(
                fn, args, leaves, spec, self.carry, self.donate, **opts)
        return cap(leaves, steps)

    def graphs(self) -> list:
        """The captures held."""
        return [c for c in self.captures.values() if not isinstance(c, int)]

    def memory(self) -> int:
        """Device bytes the captures keep: their static inputs and their
        graphs' private pools."""
        return sum(c.static_bytes + c.pool_bytes for c in self.graphs())


def _tensors(x):
    """The tensors of a tree (anything else ignored)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


class jit:  # noqa: N801 -- named after jax.jit, whose call sites it takes
    """``fn`` as the JAX package's ``jax.jit(fn)``: the eager ``fn`` on
    CPU tensors, within ``eager()`` and inside another capture or its
    warm-up (inlined, as a jit inside a jit); on CUDA tensors a
    ``Graphed`` capture per key (at most ``MAX_CAPTURES``), replayed.
    ``updates``: fn is a training step (``Graphed``'s updates).
    ``.eager`` is fn, ``.graphed`` the Graphed."""

    def __init__(self, fn: Callable, *, updates: bool = False):
        self.eager = fn
        self.graphed = Graphed(fn, max_captures=MAX_CAPTURES,
                               updates=updates)
        functools.update_wrapper(self, fn)
        named = getattr(fn, "func", fn)  # a functools.partial's function
        self.name = getattr(named, "__qualname__", type(fn).__qualname__)
        _UNITS.add(self)

    def __call__(self, *args, **kwargs):
        if _eager or _inside or not any(
                t.device.type == CAPTURED_DEVICE
                for t in _tensors((args, kwargs))):
            return self.eager(*args, **kwargs)
        return self.graphed(*args, **kwargs)

    def captures(self) -> int:
        return len(self.graphed.graphs())

    def memory(self) -> int:
        return self.graphed.memory()


_UNITS = weakref.WeakSet()


def units():
    """The live ``jit`` units."""
    return list(_UNITS)


def constant(a, dtype, device) -> torch.Tensor:
    """The host array `a` as a tensor of `dtype` on `device`, made once
    and kept: a capture refuses a copy from pageable memory, so a
    captured body reads its tables through this.  Callers do not write
    into it."""
    a = np.asarray(a)
    key = (a.tobytes(), a.shape, a.dtype.str, dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.as_tensor(a, dtype=dtype, device=device)
    return t


_CONSTANTS = {}
