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
  static buffer the graph reads; a constant is baked into the graph;
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
  in ``ops._build.COUNTED``) move only for launches on the device: the
  warm-up's and the capture's Python calls are taken back, and each
  replay adds the counts the capture recorded.

Only CUDA tensors are captured; a capture that fails raises, and
nothing falls back to eager.  The CPU path of the callers stays eager.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from .ops._build import COUNTED

# eager calls before a capture: the first builds the cached tables, the
# second runs as the capture will, with every table in place
WARMUP = 2


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
    if isinstance(x, (bool, int, float, str)):
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


class _Capture:
    """One graph: its static buffers, its outputs and its counts."""

    def __init__(self, fn, args, leaves, spec, carry, donate):
        dev = leaves[0].device
        n_first = len(_flatten(args[0])[0]) if carry is not None else 0
        first = leaves[:n_first]
        adopt = (
            donate and all(_dense(t) for t in first)
            and len(set(_storages(first))) == n_first
            and not set(_storages(first)) & set(_storages(leaves[n_first:]))
        )
        self.static = [
            t if adopt and i < n_first
            else torch.empty(t.shape, dtype=t.dtype, device=dev).copy_(t)
            for i, t in enumerate(leaves)
        ]
        self.n_first = n_first
        self.first_spec = spec[2][0]
        self.carry = carry
        self.donate = donate
        s_args = _build(spec, iter(self.static))
        # a wrapper registered during the warm-up (its module imported
        # there) starts from 0
        before = {w: w.launches for w in COUNTED.values()}
        side = torch.cuda.Stream(dev)
        try:
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    fn(*s_args)
            torch.cuda.current_stream(dev).wait_stream(side)
            before = {w: before.get(w, 0) for w in COUNTED.values()}
            for w, b in before.items():
                w.launches = b
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side):
                out = fn(*s_args)
                if carry is not None:
                    self._write_back(out)
            self.counts = {w: w.launches - b for w, b in before.items()
                           if w.launches != b}
        finally:
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
    """``fn(*args)`` on CUDA tensors, captured once per key and replayed.

    carry: None, "all" (the whole output is the next first argument) or
    the index of that part in a tuple output.  donate: the first
    argument is consumed and the carried output returned in its buffers
    (needs carry).  key: a function of no arguments whose value joins
    the cache key.
    """

    def __init__(self, fn: Callable, *, carry: Optional[Union[str, int]] =
                 None, donate: bool = False,
                 key: Callable[[], tuple] = tuple):
        if donate and carry is None:
            raise ValueError("donate needs carry: the output it aliases")
        self.fn = fn
        self.carry = carry
        self.donate = donate
        self.key = key
        self.captures = {}

    def __call__(self, *args, steps: int = 1):
        leaves, spec = _flatten(args)
        if not leaves or any(t.device.type != "cuda" for t in leaves):
            raise ValueError("Graphed steps take CUDA tensors only")
        if len({t.device for t in leaves}) != 1:
            raise ValueError("Graphed steps take tensors on one device")
        if any(t.requires_grad for t in leaves):
            raise ValueError(
                "a replayed graph is not differentiable: differentiate "
                "the eager step instead"
            )
        if steps != 1 and self.carry != "all":
            raise ValueError("steps != 1 needs carry=\"all\"")
        if steps == 0:
            return args[0]
        key = (spec, self.key())
        cap = self.captures.get(key)
        if cap is None:
            cap = self.captures[key] = _Capture(
                self.fn, args, leaves, spec, self.carry, self.donate,
            )
        return cap(leaves, steps)
