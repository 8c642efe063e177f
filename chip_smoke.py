"""Smoke check of the PyTorch/CUDA port (fv3net_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: require CUDA; print the card, its power limit, torch/CUDA;
  2. build: compile the four kernels (csrc/*.cu) with nvcc;
  3. kernels: each kernel against its plain torch version on the card,
     f32, at the padded widths of C12, C48 and C192 (N = 18, 54, 198),
     nz = 63, seeded inputs; max error and CUDA-event times (median of
     20 calls) of kernel and plain version;
  4. slice parity: one dt at C12 x 63 f32 on CUDA (kernels) against the
     same dt on the CPU (plain torch) in f32 and float64, every state
     field (see F32_FACTOR);
  5. main path: the benchmark's C48 x 63 nonhydrostatic step
     (make_dycore_stepper, k_split=1, n_split=6, hord=5, kord=9, f32) on
     CUDA: per-dt kernel launch counts, ms per dt (CUDA events), finite
     state, global dry-mass conservation, one dt against the CPU as in 4.
The last two lines are the kernels' JSON summary and
{"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import time
import types

import numpy as np
import torch

from fv3net_tpu_torch.constants import GRAV
from fv3net_tpu_torch.dycore import riemann, sw
from fv3net_tpu_torch.dycore.hydro import benchmark_state, make_dycore_stepper
from fv3net_tpu_torch.grid import CubedSphereGrid, halo_exchange
from fv3net_tpu_torch.ops import _build, advection, cuda_column
from fv3net_tpu_torch.ops.cuda_filter import del4_filter_cuda
from fv3net_tpu_torch.ops.cuda_sim1 import sim1_solver_cuda
from fv3net_tpu_torch.ops.cuda_tp import fv_tp_2d_cuda

H, NZ, DT_ATMOS, PTOP = 3, 63, 900.0, 300.0
WRAPPERS = {
    "fv_tp_2d": fv_tp_2d_cuda,
    "sim1_solver": sim1_solver_cuda,
    "del4_filter": del4_filter_cuda,
    "column_pressures": cuda_column.column_pressures_cuda,
}
META = {
    "fv_tp_2d": ("fv3net_tpu_torch/csrc/tp2d.cu",
                 "fv3net_tpu/ops/pallas_tp.py:262"),
    "sim1_solver": ("fv3net_tpu_torch/csrc/sim1.cu",
                    "fv3net_tpu/ops/pallas_sim1.py:147"),
    "del4_filter": ("fv3net_tpu_torch/csrc/filter.cu",
                    "fv3net_tpu/ops/pallas_filter.py:60"),
    "column_pressures": ("fv3net_tpu_torch/csrc/column.cu",
                         "fv3net_tpu/ops/pallas_column.py:56"),
}
# launches per dt on the main path: 5 transports x 6 substeps + 1 tracer,
# 1 vertical solve, 4 filters and 2 column chains per substep
LAUNCHES_PER_DT = {
    "fv_tp_2d": 31, "sim1_solver": 6, "del4_filter": 24,
    "column_pressures": 12,
}
# slice tolerance: u, v and w after one dt are small residuals of large
# cancelling terms, so one f32 dt differs from the float64 dt by ~1e-2 of
# their magnitude on ANY device (CPU f32 vs f64 at C12x63: u 3.0e-3, w
# 1.5e-2 relative).  The CUDA f32 step (kernels) must be as close to the
# float64 CPU step as the plain f32 CPU step is, per field:
# max|cuda - f64| <= F32_FACTOR * max|cpu32 - f64| + 1e-7 * max|f64|
F32_FACTOR = 3.0
MASS_BOUND = 1e-5  # |relative change of global dry mass| over the run


def say(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Median CUDA-event time of fn() in ms over `reps` calls."""
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


def check_close(name, got, want, rtol, atol, sl=np.s_[...]):
    """Assert |got - want| <= atol + rtol |want| on region sl; returns the
    max abs error."""
    g = got[sl].double().cpu()
    w = want[sl].double().cpu()
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    max_err = float(err.max())
    if bool(bad.any()) or not bool(torch.isfinite(g).all()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} values outside "
            f"rtol={rtol} atol={atol}, max abs err {max_err:.3e}"
        )
    return max_err


# --- phase 1 ----------------------------------------------------------------


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")


# --- phase 2 ----------------------------------------------------------------


def phase_build():
    t0 = time.perf_counter()
    _build.library()
    say(f"build: {time.perf_counter() - t0:.1f} s -> "
        f"{_build.build_info['path']}")
    say(_build.build_info["log"].strip())


# --- phase 3 ----------------------------------------------------------------


def _tp_inputs(rng, N, dev):
    def r(*s):
        return torch.as_tensor(rng.randn(*s).astype(np.float32), device=dev)

    sh = (6, NZ, N, N)
    area = 1.0 + 0.1 * torch.as_tensor(
        rng.rand(6, 1, N, N).astype(np.float32), device=dev
    )
    # Courant numbers ~0.2 and fluxes ~5% of the cell area keep the inner
    # update's denominator area + div(flux) well away from zero
    return dict(
        qx=r(*sh), qy=r(*sh), crx=0.2 * r(*sh), cry=0.2 * r(*sh),
        xfx=0.05 * area * r(*sh), yfx=0.05 * area * r(*sh),
        apx=area, apy=area.clone(),
        dp=100.0 + torch.as_tensor(rng.rand(*sh).astype(np.float32),
                                   device=dev),
    )


def check_tp(rng, N, dev, stats):
    a = _tp_inputs(rng, N, dev)
    sl = np.s_[:, :, 2 : N - 2, 2 : N - 2]  # consumed faces
    errs = []
    for hord in (1, 5, 6, 8):
        for form in ("area", "mass"):
            apx, apy = a["apx"], a["apy"]
            if form == "mass":
                apx, apy = apx * a["dp"], apy * a["dp"]
            args = (a["qx"], a["qy"], a["crx"], a["cry"], a["xfx"],
                    a["yfx"], apx, apy, hord)
            got = fv_tp_2d_cuda(*args)
            want = advection.fv_tp_2d_plain(*args)
            # tolerance of the JAX kernel test (test_pallas_kernels.py:46)
            for name, g, w in zip(("fx", "fy"), got, want):
                errs.append(check_close(
                    f"fv_tp_2d N={N} hord={hord} {form} {name}", g, w,
                    1e-4, 1e-3, sl,
                ))
            if hord == 5 and form == "area":
                ms = cuda_ms(lambda: fv_tp_2d_cuda(*args))
                plain = cuda_ms(lambda: advection.fv_tp_2d_plain(*args))
    stats[("fv_tp_2d", N)] = (max(errs), ms, plain)


def _sim1_inputs(rng, n, dev):
    """Physically plausible columns (gas law needs dz < 0, dm, pt > 0)."""
    ps = 1.0e5
    pe1d = np.linspace(PTOP, ps, NZ + 1)
    pe = np.sort(
        pe1d[:, None, None] * (1.0 + 0.01 * rng.rand(6, NZ + 1, n, n)),
        axis=1,
    )
    delp = pe[:, 1:] - pe[:, :-1]
    pt = np.clip(300.0 + 30.0 * rng.randn(6, NZ, n, n), 200.0, 400.0)
    t = torch.as_tensor
    pm = riemann.layer_mean_pressure(t(delp), t(pe)).numpy()
    dz = riemann.hydrostatic_dz(t(delp), t(pt), t(pe)).numpy() * (
        1.0 + 0.05 * rng.randn(6, NZ, n, n)
    )
    w = 2.0 * rng.randn(6, NZ, n, n)
    ws = 0.5 * rng.randn(6, n, n)
    return [
        t(x.astype(np.float32), device=dev)
        for x in (delp / GRAV, pt, dz, w, pe, pm, ws)
    ]


def check_sim1(rng, n, dev, stats):
    args = _sim1_inputs(rng, n, dev)
    dt = 150.0
    got = sim1_solver_cuda(dt, *args)
    want = riemann.sim1_solver(dt, *args)
    # tolerances of the JAX kernel test (test_pallas_kernels.py:151-162)
    errs = [
        check_close(f"sim1 n={n} w2", got[0], want[0], 1e-5, 1e-4),
        check_close(f"sim1 n={n} dz2", got[1], want[1], 1e-5, 1e-3),
        check_close(f"sim1 n={n} ppe", got[2], want[2], 1e-4,
                    float(want[2].abs().max()) * 1e-4),
    ]
    ms = cuda_ms(lambda: sim1_solver_cuda(dt, *args))
    plain = cuda_ms(lambda: riemann.sim1_solver(dt, *args))
    stats[("sim1_solver", n + 2 * H)] = (max(errs), ms, plain)


def check_filter(rng, n, dev, stats):
    def t(x):
        return torch.as_tensor(x.astype(np.float32), device=dev)

    area = t(1.0 + 0.1 * rng.rand(6, n, n))
    m = types.SimpleNamespace(
        n=n, halo=H, area_px=halo_exchange(area, H, fill="x"),
        area_py=halo_exchange(area, H, fill="y"), rarea=1.0 / area,
    )
    q = t(rng.randn(6, NZ, n, n))
    c = sw.FILTER_COEF
    got = sw.scalar_filter(q, m, c)  # halo exchanges + kernel
    want = sw.scalar_filter_plain(q, m, c)
    # tolerance of the JAX kernel test (test_pallas_kernels.py:372)
    err = check_close(f"del4 n={n}", got, want, 1e-4, 1e-5)
    ms = cuda_ms(lambda: sw.scalar_filter(q, m, c))
    plain = cuda_ms(lambda: sw.scalar_filter_plain(q, m, c))
    stats[("del4_filter", n + 2 * H)] = (err, ms, plain)


def check_column(rng, N, dev, stats):
    dp = torch.as_tensor(
        (900.0 + 200.0 * rng.rand(6, NZ, N, N)).astype(np.float32),
        device=dev,
    )
    got = cuda_column.column_pressures_cuda(dp, PTOP)
    want = cuda_column.column_pressures_plain(dp, PTOP)
    # tolerances of the JAX kernel test (test_pallas_kernels.py:277-283)
    errs = [
        check_close(f"column N={N} pe", got[0], want[0], 1e-6, 0.0),
        check_close(f"column N={N} pi", got[1], want[1], 1e-5, 0.0),
        check_close(f"column N={N} pm", got[2], want[2], 1e-5, 0.0),
    ]
    ms = cuda_ms(lambda: cuda_column.column_pressures_cuda(dp, PTOP))
    plain = cuda_ms(lambda: cuda_column.column_pressures_plain(dp, PTOP))
    stats[("column_pressures", N)] = (max(errs), ms, plain)


def phase_kernels():
    rng = np.random.RandomState(0)
    stats = {}
    for n in (12, 48, 192):
        N = n + 2 * H
        check_tp(rng, N, "cuda", stats)
        check_sim1(rng, n, "cuda", stats)
        check_filter(rng, n, "cuda", stats)
        check_column(rng, N, "cuda", stats)
    for (name, N), (err, ms, plain) in sorted(stats.items()):
        say(f"kernel {name:17s} N={N:3d} max_abs_err={err:.3e} "
            f"kernel {ms:.4f} ms plain {plain:.4f} ms")
    return stats


# --- phases 4 and 5 ---------------------------------------------------------


def stepper(g, device, dtype=torch.float32):
    return make_dycore_stepper(
        g, NZ, DT_ATMOS, k_split=1, n_split=6, hord=5, kord=9,
        ptop=PTOP, dtype=dtype, device=device,
    )


def compare_states(tag, got, plain32, ref64):
    """Per field: the CUDA f32 state against the plain f32 CPU state and
    both against the float64 CPU state (see F32_FACTOR)."""
    for k in got._fields:
        a, p, r = (
            getattr(s, k).double().cpu() for s in (got, plain32, ref64)
        )
        scale = float(r.abs().max())
        e_cuda = float((a - r).abs().max())
        e_plain = float((p - r).abs().max())
        say(f"{tag} {k:5s} max|f64| {scale:.3e} max|cuda-cpu32| "
            f"{float((a - p).abs().max()):.3e} max|cuda-f64| {e_cuda:.3e} "
            f"max|cpu32-f64| {e_plain:.3e}")
        bound = F32_FACTOR * e_plain + 1e-7 * scale
        if not bool(torch.isfinite(a).all()) or e_cuda > bound:
            raise AssertionError(f"{tag} {k}: {e_cuda:.3e} > {bound:.3e}")


def cpu_references(g, n):
    """One dt of the plain path on the CPU, in f32 and in float64, from
    the same f32 initial state."""
    st = benchmark_state(n, NZ, PTOP, "cpu")
    out = []
    for dtype in (torch.float32, torch.float64):
        run, _, _ = stepper(g, "cpu", dtype)
        t0 = time.perf_counter()
        out.append(run(type(st)(*(x.to(dtype) for x in st)),
                       torch.zeros((6, n, n), dtype=dtype), 1))
        say(f"C{n}x{NZ} CPU plain dt {dtype}: "
            f"{time.perf_counter() - t0:.1f} s")
    return out


def phase_slice_parity():
    g = CubedSphereGrid.make(12, halo=H)
    run_gpu, _, _ = stepper(g, "cuda")
    phis = torch.zeros((6, 12, 12), device="cuda")
    out_gpu = run_gpu(benchmark_state(12, NZ, PTOP, "cuda"), phis, 1)
    compare_states("C12x63", out_gpu, *cpu_references(g, 12))


def dry_mass(state, m):
    return float((state.delp.double() / m.rarea.double()[:, None]).sum())


def phase_main_path():
    n = 48
    g = CubedSphereGrid.make(n, halo=H)
    run, m, _ = stepper(g, "cuda")
    state = benchmark_state(n, NZ, PTOP, "cuda")
    phis = torch.zeros((6, n, n), device="cuda")
    mass0 = dry_mass(state, m)

    for w in WRAPPERS.values():
        w.launches = 0
    first = run(state, phis, 1)  # one dt, the counted run (and warm-up)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in WRAPPERS.items()}
    say(f"C48x63 kernel launches in one dt: {launches}")
    if launches != LAUNCHES_PER_DT:
        raise AssertionError(
            f"launches {launches} != expected {LAUNCHES_PER_DT}"
        )

    steps, times = 5, []
    s = first
    for _ in range(steps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        s = run(s, phis, 1)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    ms = statistics.median(times)
    updates = 6 * n * n * NZ * 6 / (ms / 1e3)
    say(f"C48x63 ms/dt {ms:.3f} (median of {steps}: "
        f"{[round(t, 3) for t in times]}) "
        f"cell-substep-updates/s {updates:.4e}")

    for k, x in s._asdict().items():
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"C48x63: non-finite {k}")
    rel = (dry_mass(s, m) - mass0) / mass0
    say(f"C48x63 dry mass relative change over {steps + 1} dt: {rel:.3e} "
        f"(bound {MASS_BOUND})")
    if not abs(rel) <= MASS_BOUND:
        raise AssertionError(f"dry mass not conserved: {rel:.3e}")

    compare_states("C48x63", first, *cpu_references(g, n))
    return launches, ms


def main():
    phase_device()
    phase_build()
    stats = phase_kernels()
    phase_slice_parity()
    launches, _ = phase_main_path()
    kernels = []
    for name, (source, replaces) in META.items():
        err, ms, plain = stats[(name, 54)]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
