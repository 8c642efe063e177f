"""Time the remap (K5), fused-transport (K6) and transport (K1) kernels,
the del-4 filter (K3, as ``sw.scalar_filter`` calls it), the vertical
solve (K2) and the column pressures (K4) alone at the C192 path's shapes
(K2 and K4 also at C48's), and compare their outputs with another
checkout's.

Run on the GPU machine from the repository root:

    python fv3net_tpu_torch/kernel_times.py --tag NAME [--root DIR]
        [--save FILE] [--reference FILE]

imports ``fv3net_tpu_torch`` from the checkout at --root (default: this
file's own), builds its kernels there, and runs on seeded inputs (the
same in every checkout): K5 on q1/pe1/pe2 of n = 192 x 63 levels, cell
centred and u-staggered, for the (iv, kord) variants the C192 step
remaps with (pt, winds, tracers at kord 9; kord 10 and 17), and K6 on the
D stage's 16 fields of N = 198 x 63 at hord 5 (the step's) and hord 1
(the same loads and tiles without the edge arithmetic); K1 on the same
inputs' fields at N = 198 x 63, hord 5 and 1, with plain and with
mass-weighted areas; ``sw.scalar_filter`` on q [6, 63, 192, 192] with
seeded areas (chip_smoke.py's metrics); K2 on chip_smoke.py's plausible
columns at n = 192 and 48, the wrapper alone on the contiguous interior
fields and ``riemann.sim1_solve`` as the step calls it (on the
halo-padded pem, pm and ws with ``halo=3`` where the checkout's wrapper
takes a halo, else on their interior views, which it copies); K4 on dp
[6, 63, N, N] at N = 198 and 54; the probes K7 and K8
(``probe.affine_cuda``, ``probe.stencil_cuda``) on seeded [256, 256] and
[16384, 16384] arrays (1 GiB each), beside ``torch.addcmul(1, x, 2)``,
which computes K7's function.  Each call is timed by CUDA events,
median of 20 after 3 warm-up calls.  The host time of the Python call
alone (median of 20, not synchronised, the card kept busy) is taken for
the K7 and K8 probes, K1 at N = 54, K3 at n = 48, K2 and K4 at the C48
shapes, and for the pieces of the wrappers' shared call path.  --save
writes the outputs to FILE (the [16384, 16384] probes' as a sha256 of
their bytes); --reference compares them with a FILE saved by another
checkout (bit for bit, else the max abs difference).  Prints one JSON
line with the card's name and power limit.  Running two checkouts in
turns in one call (A, B, B, A) compares them on one card.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np

NZ, N192 = 63, 192
H, PTOP = 3, 300.0
REMAP_VARIANTS = ((1, 9), (-1, 9), (0, 9), (1, 10), (1, 17))
PROBE_SIZES = (256, 16384)  # the probe's [256, 256] and an HBM-bound size


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


def _sim1_inputs(rng, n):
    """chip_smoke.py's plausible columns for the vertical solve (dz < 0,
    dm, pt > 0): dm, pt, dz, w [6, 63, n, n], pe [6, 64, n, n], pm, ws,
    float32 (pm = dp / dln pe, dz hydrostatic at pm times 1 + 5% noise)."""
    from fv3net_tpu_torch.constants import CP_AIR, CV_AIR, GRAV, RDGAS
    from fv3net_tpu_torch.constants import REFERENCE_SURFACE_PRESSURE as P00

    pe = np.sort(np.linspace(PTOP, 1.0e5, NZ + 1)[:, None, None]
                 * (1.0 + 0.01 * rng.rand(6, NZ + 1, n, n)), axis=1)
    delp = np.diff(pe, axis=1)
    pt = np.clip(300.0 + 30.0 * rng.randn(6, NZ, n, n), 200.0, 400.0)
    pm = delp / np.diff(np.log(pe), axis=1)
    dm = delp / GRAV
    dz = -(dm * RDGAS * pt / P00) * (pm / P00) ** (-CV_AIR / CP_AIR) * (
        1.0 + 0.05 * rng.randn(6, NZ, n, n))
    w = 2.0 * rng.randn(6, NZ, n, n)
    ws = 0.5 * rng.randn(6, n, n)
    return [a.astype(np.float32) for a in (dm, pt, dz, w, pe, pm, ws)]


def _halo_padded(torch, a):
    """a [..., n, n] inside a halo of H cells of NaN (the step's padded
    fields around their interior)."""
    out = torch.full((*a.shape[:-2], a.shape[-2] + 2 * H,
                      a.shape[-1] + 2 * H), float("nan"), device=a.device)
    out[..., H:-H, H:-H] = a
    return out


def _step_sim1_call(torch, riemann, args):
    """riemann.sim1_solve as the step calls it: on the halo-padded pem, pm
    and ws with halo=H where sim1_solve takes a halo, else on their
    interior views."""
    padded = [_halo_padded(torch, a) for a in args[4:]]
    if "halo" in inspect.signature(riemann.sim1_solve).parameters:
        return lambda: riemann.sim1_solve(150.0, *args[:4], *padded, halo=H)
    views = [a[..., H:-H, H:-H] for a in padded]
    return lambda: riemann.sim1_solve(150.0, *args[:4], *views)


def _filter_inputs(torch, halo_exchange, rng, n):
    """sw.scalar_filter's metrics (seeded areas, their x- and y-fill
    exchanges; chip_smoke.py's check_filter) and q [6, 63, n, n]."""
    def t(a):
        return torch.as_tensor(a.astype(np.float32), device="cuda")

    area = t(1.0 + 0.1 * rng.rand(6, n, n))
    m = types.SimpleNamespace(
        n=n, halo=3, area_px=halo_exchange(area, 3, fill="x"),
        area_py=halo_exchange(area, 3, fill="y"), rarea=1.0 / area,
    )
    return m, t(rng.randn(6, NZ, n, n))


def _host_ms(torch, fn, reps=20, warmup=3):
    """Median wall time in ms of the Python call fn() alone, without
    synchronising, each after ~1 ms of queued device work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _host_times(torch, rng, probe, sw, halo_exchange, _build, fv_tp_2d_cuda,
                step_sim1, column_pressures_cuda, dp):
    """Host ms of six wrappers at the C48 path's shapes (K7 and K8 at
    their [256, 256]) and of the pieces of their call paths."""
    x = torch.as_tensor(rng.randn(*probe.SHAPE).astype(np.float32),
                        device="cuda")
    N = 54
    sh = (6, NZ, N, N)
    tp = [torch.as_tensor(a, device="cuda") for a in (
        rng.randn(*sh), rng.randn(*sh), 0.2 * rng.randn(*sh),
        0.2 * rng.randn(*sh), 0.05 * rng.randn(*sh), 0.05 * rng.randn(*sh),
        1.0 + 0.1 * rng.rand(6, 1, N, N), 1.0 + 0.1 * rng.rand(6, 1, N, N),
    )]
    tp = [a.float() for a in tp]
    m, q = _filter_inputs(torch, halo_exchange, rng, 48)
    return {
        "probe_affine [256, 256]": _host_ms(torch,
                                            lambda: probe.affine_cuda(x)),
        "probe_stencil [256, 256]": _host_ms(torch,
                                             lambda: probe.stencil_cuda(x)),
        "fv_tp_2d N=54 hord=5": _host_ms(torch,
                                         lambda: fv_tp_2d_cuda(*tp, 5)),
        "scalar_filter n=48": _host_ms(
            torch, lambda: sw.scalar_filter(q, m, sw.FILTER_COEF)),
        "sim1_solve n=48 (the step's call)": _host_ms(torch, step_sim1),
        "column_pressures_cuda N=54": _host_ms(
            torch, lambda: column_pressures_cuda(dp, PTOP)),
        "_build.stream()": _host_ms(torch, _build.stream),
        "torch.empty [6, 63, 54, 54]": _host_ms(
            torch, lambda: torch.empty(sh, device="cuda")),
        "_build.check": _host_ms(
            torch, lambda: _build.check(tp[0], "q", sh, tp[0].device)),
        "torch.empty_like [256, 256]": _host_ms(
            torch, lambda: torch.empty_like(x)),
        "C entry (the probe's launch)": _host_ms(
            torch, _probe_launch(probe, _build, x)),
        **({} if not hasattr(probe, "affine_plan") else {
            "probe.affine_plan [256, 256] (cached)": _host_ms(
                torch, lambda: probe.affine_plan(
                    x.numel(), x.data_ptr() & 15, x.data_ptr() & 15,
                    135168)),
            "probe.affine_plan [256, 256] (uncached)": _host_ms(
                torch, lambda: probe.affine_plan.__wrapped__(
                    x.numel(), x.data_ptr() & 15, x.data_ptr() & 15,
                    135168))}),
    }


def _probe_launch(probe, _build, x):
    """K7's launch on x alone, as the checkout's wrapper makes it: its C
    entry through ``_build.call`` (the four-argument entry), or bound once
    and given the wrapper's plan."""
    n, p = x.numel(), x.data_ptr()
    if len(_build.SIGNATURES["fv3_probe_affine"]) == 4:
        return lambda: _build.call("fv3_probe_affine", p, p, n,
                                   _build.stream())
    affine, _, max_blocks, _ = probe._entry or probe._bind()
    plan = probe.affine_plan(n, p & 15, p & 15, max_blocks)
    return lambda: affine(p, p, n, *plan, _build.stream())


def _probe_times(torch, probe, times, outs):
    """K7 and K8 at PROBE_SIZES on seeded arrays made on the card, and
    torch.addcmul(1, x, 2) beside K7; outputs above [256, 256] kept as
    the sha256 of their bytes."""
    one, two = (torch.tensor(v, device="cuda") for v in (1.0, 2.0))
    for n in PROBE_SIZES:
        gen = torch.Generator(device="cuda").manual_seed(n)
        x = torch.randn((n, n), device="cuda", generator=gen)
        for name, fn in (("probe_affine", probe.affine_cuda),
                         ("probe_stencil", probe.stencil_cuda)):
            key = f"{name} [{n}, {n}]"
            y = fn(x).cpu()
            outs[key] = y if n <= 256 else hashlib.sha256(
                y.numpy().tobytes()).hexdigest()
            del y
            times[key] = _cuda_ms(torch, lambda: fn(x))
        times[f"torch.addcmul [{n}, {n}]"] = _cuda_ms(
            torch, lambda: torch.addcmul(one, x, two))
        del x
        torch.cuda.empty_cache()


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

    from fv3net_tpu_torch import probe
    from fv3net_tpu_torch.dycore import riemann, sw
    from fv3net_tpu_torch.grid import halo_exchange
    from fv3net_tpu_torch.ops import _build
    from fv3net_tpu_torch.ops.cuda_column import column_pressures_cuda
    from fv3net_tpu_torch.ops.cuda_remap import ppm_remap_cuda
    from fv3net_tpu_torch.ops.cuda_sim1 import sim1_solver_cuda
    from fv3net_tpu_torch.ops.cuda_tp import (fv_tp_2d_cuda,
                                              fv_tp_2d_multi5_cuda)

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
    # K1 on delp's fields with (xfx, yfx) and the plain areas, or the air
    # mass area * delp
    dpx, dpy, crx, cry, xfx, yfx = (ins[i] for i in (0, 1, 10, 11, 12, 13))
    apx, apy = ins[16][:, None], ins[17][:, None]
    for form, areas in (("area", (apx, apy)),
                        ("mass", (apx * dpx, apy * dpy))):
        tp = (dpx, dpy, crx, cry, xfx, yfx, *areas)
        for hord in (5, 1):
            key = f"fv_tp_2d N=198 hord={hord} {form}"
            outs[key] = [o.cpu() for o in fv_tp_2d_cuda(*tp, hord)]
            times[key] = _cuda_ms(torch, lambda: fv_tp_2d_cuda(*tp, hord))
    del ins, tp, areas
    m, q = _filter_inputs(torch, halo_exchange, rng, N192)
    key = f"scalar_filter n={N192}"
    outs[key] = sw.scalar_filter(q, m, sw.FILTER_COEF).cpu()
    times[key] = _cuda_ms(torch, lambda: sw.scalar_filter(q, m,
                                                          sw.FILTER_COEF))
    del m, q
    for n in (N192, 48):
        cols = [torch.as_tensor(a, device="cuda")
                for a in _sim1_inputs(rng, n)]
        key = f"sim1_solver_cuda n={n} (contiguous interior)"
        outs[key] = [o.cpu() for o in sim1_solver_cuda(150.0, *cols)]
        times[key] = _cuda_ms(torch, lambda: sim1_solver_cuda(150.0, *cols))
        step_sim1 = _step_sim1_call(torch, riemann, cols)
        key = f"sim1_solve n={n} (the step's call)"
        outs[key] = [o.cpu() for o in step_sim1()]
        times[key] = _cuda_ms(torch, step_sim1)
        N = n + 2 * H
        dp = torch.as_tensor(
            (900.0 + 200.0 * rng.rand(6, NZ, N, N)).astype(np.float32),
            device="cuda")
        key = f"column_pressures_cuda N={N}"
        outs[key] = [o.cpu() for o in column_pressures_cuda(dp, PTOP)]
        times[key] = _cuda_ms(torch, lambda: column_pressures_cuda(dp, PTOP))
    _probe_times(torch, probe, times, outs)
    host = _host_times(torch, rng, probe, sw, halo_exchange, _build,
                       fv_tp_2d_cuda, step_sim1, column_pressures_cuda, dp)
    result = {"tag": args.tag, "root": root, "card": card, "ms": times,
              "host_ms": host}
    if reference:
        ref = torch.load(reference)
        diff = {}
        for k, v in outs.items():
            if isinstance(v, str):  # a sha256 of the output's bytes
                diff[k] = "bit for bit" if v == ref[k] else "differs"
                continue
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
