"""Diagnostic-function registry (a copy of the JAX package's
``diagnostics/registry.py``;
workflows/diagnostics/fv3net/diagnostics/_shared/registry.py:12
equivalent).  The reference fans the registered functions out with
joblib (`registry.py:27` `Parallel(n_jobs=...)`); here `compute`
accepts `workers=N` and fans out over a thread pool -- the functions
are numpy/torch reductions that release the GIL inside the math
kernels, so threads give the joblib-style wall-clock win without the
process-spawn cost (and device tensors stay shareable)."""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict

logger = logging.getLogger(__name__)


class Registry:
    def __init__(self, merge: Callable = None):
        self.funcs: Dict[str, Callable] = {}
        self.merge = merge or (lambda d: d)

    def register(self, name: str):
        def wrap(fn):
            if name in self.funcs:
                raise ValueError(f"duplicate diagnostic {name!r}")
            self.funcs[name] = fn
            return fn

        return wrap

    def compute(self, *args, workers: int = 1, **kwargs):
        """Run every registered function; `workers > 1` fans out over
        a thread pool (the reference's joblib-parallel batch tier).
        Output order and failure handling are identical either way."""
        results: Dict[str, object] = {}
        if workers > 1 and len(self.funcs) > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                futs = {
                    name: pool.submit(fn, *args, **kwargs)
                    for name, fn in self.funcs.items()
                }
            for name, fut in futs.items():
                try:
                    results[name] = fut.result()
                except Exception:
                    logger.exception("diagnostic %s failed", name)
        else:
            for name, fn in self.funcs.items():
                try:
                    results[name] = fn(*args, **kwargs)
                except Exception:
                    logger.exception("diagnostic %s failed", name)
        out = {}
        for name in self.funcs:
            if name not in results:
                continue
            result = results[name]
            if isinstance(result, dict):
                for k, v in result.items():
                    out[f"{k}_{name}" if k else name] = v
            else:
                out[name] = result
        return self.merge(out)
