"""Time the remap (K5) and fused-transport (K6) kernels alone at the C192
path's shapes, and compare their outputs with another checkout's.

Run on the GPU machine from the repository root:

    python fv3net_tpu_torch/kernel_times.py --tag NAME [--root DIR]
        [--save FILE] [--reference FILE]

imports ``fv3net_tpu_torch`` from the checkout at --root (default: this
file's own), builds its kernels there, and runs on seeded inputs (the
same in every checkout): K5 on q1/pe1/pe2 of n = 192 x 63 levels, cell
centred and u-staggered, for the (iv, kord) variants the C192 step
remaps with (pt, winds, tracers at kord 9; kord 10 and 17), and K6 on the
D stage's 16 fields of N = 198 x 63 at hord 5 (the step's) and hord 1
(the same loads and tiles without the edge arithmetic).  Each wrapper
call is timed
by CUDA events, median of 20 after 3 warm-up calls.  --save writes the
outputs to FILE; --reference compares them with a FILE saved by another
checkout (bit for bit, else the max abs difference).  Prints one JSON
line with the card's name and power limit.  Running two checkouts in
turns in one call (A, B, B, A) compares them on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np

NZ, N192 = 63, 192
REMAP_VARIANTS = ((1, 9), (-1, 9), (0, 9), (1, 10), (1, 17))


def _cuda_ms(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def _remap_inputs(rng, ny, nx):
    """Monotone source and target edges from positive spacings, sharing
    the column's end points, and q = 1 + white noise (chip_smoke.py's
    remap inputs)."""
    def edges():
        w = np.cumsum(0.2 + rng.rand(6, NZ + 1, ny, nx), axis=1)
        return (w - w[:, :1]) / (w[:, -1:] - w[:, :1])

    ps = 1.0e5 * (1.0 + 0.02 * rng.rand(6, 1, ny, nx))
    pe1 = 300.0 + edges() * (ps - 300.0)
    pe2 = 300.0 + edges() * (ps - 300.0)
    q = 1.0 + rng.randn(6, NZ, ny, nx)
    return [a.astype(np.float32) for a in (q, pe1, pe2)]


def _multi5_inputs(rng, N):
    """The D stage's 16 fields and 2 areas at physical scaling (Courant
    numbers ~0.2, fluxes ~5% of the cell area, delp ~100)."""
    def r():
        return rng.randn(6, NZ, N, N).astype(np.float32)

    apx = (1.0 + 0.1 * rng.rand(6, N, N)).astype(np.float32)
    apy = apx + np.float32(0.01)
    fields = [100.0 + np.abs(r()), 100.0 + np.abs(r()), 300.0 + 10.0 * r(),
              300.0 + 10.0 * r(), r(), r(), -100.0 + 5.0 * r(),
              -100.0 + 5.0 * r(), 1e-4 * r(), 1e-4 * r(), 0.2 * r(),
              0.2 * r()]
    fields += [0.05 * a[:, None] * r() for a in (apx, apy, apx, apy)]
    return [f.astype(np.float32) for f in fields] + [apx, apy]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", required=True)
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--save")
    ap.add_argument("--reference")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    save, reference = (
        os.path.abspath(f) if f else None for f in (args.save, args.reference)
    )
    sys.path.insert(0, root)
    os.chdir(root)  # the kernels build under <root>/build/kernels
    import torch

    from fv3net_tpu_torch.ops import _build
    from fv3net_tpu_torch.ops.cuda_remap import ppm_remap_cuda
    from fv3net_tpu_torch.ops.cuda_tp import fv_tp_2d_multi5_cuda

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_times needs a CUDA device")
    _build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    rng = np.random.RandomState(192)
    times, outs = {}, {}
    for stag in ((0, 0), (1, 0)):
        q, pe1, pe2 = (
            torch.as_tensor(a, device="cuda")
            for a in _remap_inputs(rng, N192 + stag[0], N192 + stag[1])
        )
        for iv, kord in REMAP_VARIANTS:
            key = f"ppm_remap stag={stag} iv={iv} kord={kord}"
            outs[key] = ppm_remap_cuda(q, pe1, pe2, iv, kord).cpu()
            times[key] = _cuda_ms(
                torch, lambda: ppm_remap_cuda(q, pe1, pe2, iv, kord)
            )
        del q, pe1, pe2
    ins = [torch.as_tensor(a, device="cuda")
           for a in _multi5_inputs(rng, N192 + 6)]
    for hord in (5, 1):  # hord 1: the same tiles without edge arithmetic
        key = f"fv_tp_2d_multi5 N=198 hord={hord}"
        outs[key] = [o.cpu() for o in fv_tp_2d_multi5_cuda(*ins, hord)]
        times[key] = _cuda_ms(
            torch, lambda: fv_tp_2d_multi5_cuda(*ins, hord)
        )
    del ins
    result = {"tag": args.tag, "root": root, "card": card, "ms": times}
    if reference:
        ref = torch.load(reference)
        diff = {}
        for k, v in outs.items():
            a = v if isinstance(v, list) else [v]
            b = ref[k] if isinstance(ref[k], list) else [ref[k]]
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            diff[k] = "bit for bit" if same else max(
                float((x - y).abs().max()) for x, y in zip(a, b)
            )
        result["against_reference"] = diff
    if save:
        os.makedirs(os.path.dirname(save), exist_ok=True)
        torch.save(outs, save)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
