"""The operation count of one step of a configuration, for ``step_mfu``.

A ``TorchDispatchMode`` runs over the plain reference's dt
(``reference/``) at the configuration's shapes, from the seed's input
state, and counts the arithmetic of every aten op by the BOUND_NOTE
convention (``roofline.py``): each add, multiply, divide, min/max,
compare-select, power, logarithm and other elementwise function as one
per output element (a clamp as one per bound it applies; the select of a
``where`` is the second half of a compare-select and counts nothing), a
reduction or prefix sum as one per input element.  Copies, gathers,
concatenations, rolls and fills move data and count nothing; ops the
table does not know count nothing and are listed.  So the count is the
work of the step, whatever implements it, and never more.

    python3 portbench/opcount.py --config C48x63 [--device cpu]
        [--resolution N --nz NZ]

prints one JSON line with ``step_ops`` (run it on the card for the
configuration's own shapes; the value goes into the configuration's
file, with this command beside it).
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ONE = {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "minimum", "maximum",
    "pow", "log", "log2", "log10", "log1p", "exp", "exp2", "expm1", "sqrt",
    "rsqrt", "reciprocal", "sign", "sgn", "floor", "ceil", "round", "trunc",
    "tanh", "sin", "cos", "atan", "atan2", "square", "lt", "gt", "le", "ge",
    "eq", "ne", "logical_and", "logical_or", "logical_not", "bitwise_and",
    "bitwise_or", "bitwise_not", "fmod", "remainder", "copysign", "hypot",
    "sigmoid", "erf",
}
TWO = {"addcmul", "addcdiv", "lerp"}
REDUCE = {"sum", "cumsum", "mean", "amax", "amin", "prod", "cumprod",
          "max", "min", "norm", "linalg_vector_norm", "any", "all"}
CLAMP = {"clamp", "clamp_min", "clamp_max"}
FREE = {
    "copy", "_to_copy", "clone", "view", "_unsafe_view", "reshape",
    "expand", "permute", "transpose", "t", "slice", "select", "index",
    "index_select", "gather", "cat", "stack", "roll", "zeros_like",
    "ones_like", "empty_like", "full_like", "zeros", "ones", "empty",
    "full", "fill", "new_zeros", "new_empty", "new_full", "new_ones",
    "arange", "detach", "alias", "unsqueeze", "squeeze", "flatten",
    "movedim", "split", "split_with_sizes", "unbind", "narrow",
    "as_strided", "contiguous", "lift_fresh", "scalar_tensor", "where",
    "repeat", "index_put", "slice_scatter", "select_scatter",
    "constant_pad_nd", "flip", "masked_fill", "_local_scalar_dense",
    "unfold", "set_", "resize_", "empty_strided", "zero", "tensor",
    "_index_put_impl", "index_add", "scatter", "scatter_add", "diagonal",
    "view_as", "expand_as", "triu", "tril", "slice_backward",
    "select_backward", "new_empty_strided",
}


def _name(func) -> str:
    return func.overloadpacket.__name__.rstrip("_")


def _numel(x) -> int:
    return sum(_numel(t) for t in x) if isinstance(x, (list, tuple)) else (
        x.numel() if isinstance(x, torch.Tensor) else 0)


class OpCounter(TorchDispatchMode):
    """Counts the operations of every aten op run inside it
    (module docstring)."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.by_op = collections.Counter()
        self.uncounted = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = _name(func)
        if name in ONE:
            n = _numel(out)
        elif name in TWO:
            n = 2 * _numel(out)
        elif name in REDUCE:
            n = _numel(args[0])
        elif name in CLAMP:
            bounds = list(args[1:3]) + [kwargs.get(k) for k in ("min", "max")]
            n = _numel(out) * sum(b is not None for b in bounds)
        else:
            if name not in FREE:
                self.uncounted[name] += 1
            n = 0
        self.ops += n
        self.by_op[name] += n
        return out


def count_step(cfg, traffic, seed: int, device) -> OpCounter:
    """The operations of one reference dt of `cfg` from the seed's state."""
    from portbench.entries.dycore import initial_state, reference_dt

    one_dt, _ = reference_dt(cfg, torch.float32, device)
    state = initial_state(cfg, traffic, seed, device)
    phis = torch.zeros((6, cfg["resolution"], cfg["resolution"]),
                       device=device)
    counter = OpCounter()
    with counter:
        one_dt(state, phis)
    return counter


def main(argv=None):
    root = Path(__file__).resolve().parent.parent
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resolution", type=int)
    p.add_argument("--nz", type=int)
    args = p.parse_args(argv)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == args.config)
    cfg = json.loads((root / entry["file"]).read_text())
    for k in ("resolution", "nz"):
        if getattr(args, k) is not None:
            cfg[k] = getattr(args, k)
    traffic = json.loads((root / "portbench/traffic/dycore.json").read_text())
    c = count_step(cfg, traffic, args.seed, torch.device(args.device))
    print(json.dumps({
        "config": args.config, "resolution": cfg["resolution"],
        "nz": cfg["nz"], "step_ops": c.ops,
        "by_op": dict(c.by_op.most_common()),
        "uncounted": dict(c.uncounted),
    }))


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    main()
