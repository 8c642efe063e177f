"""Smoke check of the PyTorch/CUDA port (fv3net_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: require CUDA; print the card, its power limit, torch/CUDA;
  2. build: compile the eight kernels (csrc/*.cu) with nvcc, then the
     toolchain probe path (fv3net_tpu_torch.probe, K7 x*2+1 and K8 the
     3-point lane stencil on [256, 256]): launch counts, each kernel
     bit for bit equal to its plain version, times;
  3. kernels: each dycore kernel against its plain torch version on the
     card, f32, nz = 63, seeded inputs, at the widths of C12, C48 and
     C192 (padded N = 18, 54, 198; the remap at n = 12, 48, 192 in its
     cell-centred, u- and v-staggered shapes); max error and CUDA-event
     times (median of 20 calls) of each kernel's wrapper alone on
     pre-built inputs (K3 on its pre-exchanged pair, beside the time of
     scalar_filter with its two exchanges) and of its plain version,
     each beside its bound (BOUND_NOTE) and, for K7, beside one PyTorch
     call that computes the same function; K6 also against five K1
     calls;
  4. slice parity: one dt at C12 x 63 f32 on CUDA (kernels) against the
     same dt on the CPU (plain torch) in f32 and float64, every state
     field (see F32_FACTOR), with the fused transport off and on;
  5. main path: the benchmark's C48 x 63 nonhydrostatic step
     (make_dycore_stepper, k_split=1, n_split=6, hord=5, kord=9, f32,
     fused transport off as the JAX package's default) on CUDA: per-dt
     kernel launch counts, ms per dt (CUDA events), finite state, global
     dry-mass conservation, one dt against the CPU as in 4;
  6. C192 kernel path: the C192 x 63 step with the fused transport on
     (dt_atmos=225, bench.py rung 2), the configuration in which the JAX
     package runs its remap and fused-transport kernels: launch counts,
     ms per dt, finite state, dry mass, and one dt against the same dt
     with the fused transport off (see FUSED_BOUND).  A float64 CPU
     reference dt at C192 is out of reach (memory and hours of CPU), so
     this path is held to the unfused card dt, which phases 3-5 hold to
     the CPU.
  7. exchange transposes: at the widths of C48 and C192 (nz = 63, f32),
     the vjp of each staggered halo exchange (D grid; C grid, fill x and
     y) through its gather-form transpose (grid/halo_transpose.py)
     against torch.func.vjp of the plain gather (autograd's scatter-add):
     max error and CUDA-event ms of each;
  8. coupled parity: one coupled step (runtime.compiled_loop: dycore +
     gray radiation + GFS physics + the dense ML corrector, bench.py rung
     3's configuration, runtime.coupled_bench) at C12 x 63 from a
     perturbed state moist enough to rain (seeded relative humidity up
     to 1.1), on CUDA in f32 against the CPU in f32 and float64,
     every state field and total_precip by phase 4's rule; columns where
     a physics threshold decided differently in the two f32 runs are
     counted, masked and bounded (FLIP_BOUND);
  9. coupled path: bench.py rung 3 at C48 x 63 (the dense model written
     from a seed in the JAX package's dump format, read back through
     fit.load): per-step kernel launches, ms per step and simulated
     years per day (CUDA events), ms per stage (dynamics, physics,
     postphysics), finite state, mass gates of each stage and the ML
     fill fractions.
Launch counts are read per path: K7/K8 on the probe path, K1-K5 on the
C48 main path and on the coupled C48 path, K6 on the C192 path.  Each
kernel's JSON entry holds its launches and its phase-3 numbers at the
shapes of the path its launches come from (K1-K5 C48, K6 C192, K7/K8
[256, 256]).  The last two lines are the kernels' JSON summary and
{"ok": true, "device": {...}}.
"""

import json
import os
import re
import statistics
import subprocess
import time
import types

import numpy as np
import torch

from fv3net_tpu_torch import probe, wrapper
from fv3net_tpu_torch.constants import GRAV
from fv3net_tpu_torch.dycore import riemann, sw
from fv3net_tpu_torch.dycore.hydro import benchmark_state, make_dycore_stepper
from fv3net_tpu_torch.grid import CubedSphereGrid, halo_exchange
from fv3net_tpu_torch.grid import halo as halo_mod
from fv3net_tpu_torch.ops import _build, advection, cuda_column, remap
from fv3net_tpu_torch.ops.cuda_filter import del4_filter_cuda
from fv3net_tpu_torch.ops.cuda_remap import ppm_remap_cuda
from fv3net_tpu_torch.ops.cuda_sim1 import sim1_solver_cuda
from fv3net_tpu_torch.ops.cuda_tp import fv_tp_2d_cuda, fv_tp_2d_multi5_cuda
from fv3net_tpu_torch.physics import gfs
from fv3net_tpu_torch.runtime import compiled_loop, coupled_bench

H, NZ, DT_ATMOS, PTOP = 3, 63, 900.0, 300.0
DT_C192 = 225.0  # bench.py rung 2
WRAPPERS = {
    "fv_tp_2d": fv_tp_2d_cuda,
    "sim1_solver": sim1_solver_cuda,
    "del4_filter": del4_filter_cuda,
    "column_pressures": cuda_column.column_pressures_cuda,
    "ppm_remap": ppm_remap_cuda,
    "fv_tp_2d_multi5": fv_tp_2d_multi5_cuda,
    "probe_affine": probe.affine_cuda,
    "probe_stencil": probe.stencil_cuda,
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
    "ppm_remap": ("fv3net_tpu_torch/csrc/remap.cu",
                  "fv3net_tpu/ops/pallas_remap.py:405"),
    "fv_tp_2d_multi5": ("fv3net_tpu_torch/csrc/tp2d_multi5.cu",
                        "fv3net_tpu/ops/pallas_tp.py:213"),
    "probe_affine": ("fv3net_tpu_torch/csrc/probe.cu",
                     "tools/probe_pallas.py:13"),
    "probe_stencil": ("fv3net_tpu_torch/csrc/probe.cu",
                      "tools/probe_pallas.py:34"),
}
# launches per dt on the C48 main path (fused transport off): 5 transports
# x 6 substeps + 1 tracer, 1 vertical solve, 4 filters and 2 column chains
# per substep, and 6 remaps (pt, u, v, w, delz via sv, the tracer stack)
LAUNCHES_PER_DT = {
    "fv_tp_2d": 31, "sim1_solver": 6, "del4_filter": 24,
    "column_pressures": 12, "ppm_remap": 6, "fv_tp_2d_multi5": 0,
    "probe_affine": 0, "probe_stencil": 0,
}
# ... on the C192 path (fused transport on): the five substep transports
# are one fused launch, K1 runs only for the tracer
LAUNCHES_PER_DT_FUSED = dict(LAUNCHES_PER_DT, fv_tp_2d=1, fv_tp_2d_multi5=6)
# ... on the toolchain probe path: one call of each probe
LAUNCHES_PROBE = dict(
    {k: 0 for k in WRAPPERS}, probe_affine=1, probe_stencil=1
)
# slice tolerance: u, v and w after one dt are small residuals of large
# cancelling terms, so one f32 dt differs from the float64 dt by ~1e-2 of
# their magnitude on ANY device (CPU f32 vs f64 at C12x63: u 3.0e-3, w
# 1.5e-2 relative).  The CUDA f32 step (kernels) must be as close to the
# float64 CPU step as the plain f32 CPU step is, per field:
# max|cuda - f64| <= F32_FACTOR * max|cpu32 - f64| + 1e-7 * max|f64|
F32_FACTOR = 3.0
MASS_BOUND = 1e-5  # |relative change of global dry mass| over the run
# C192: one dt with the fused transport on against the same dt with it off,
# on the card, per field: max|fused - unfused| <= FUSED_BOUND * max|field|.
# K6 reproduces five K1 calls (gated at FUSED_RTOL in phase 3; equal bit
# for bit on the card so far) and every other operation of the dt is the
# same code on the same inputs, so the two dts differ by no more than the
# f32 roundoff (~1e-7) of K6 against K1, carried through 6 substeps and
# the remap, in which u, v and w are small residuals of large terms that
# amplify it by ~1e2 (phase 4's f32 vs f64 spread).  1e-5 of each field's
# magnitude is that bound.
FUSED_BOUND = 1e-5
FUSED_RTOL = 1e-6  # K6 vs five K1 calls: max|diff| <= FUSED_RTOL * max|K1|
# ... on the coupled path: the dycore's launches with two tracers (the
# wrapper's specific humidity and cloud water), so one more transport
LAUNCHES_COUPLED = dict(LAUNCHES_PER_DT, fv_tp_2d=32)
# exchange transposes against autograd's: each adjoint entry is a sum of
# up to 5 signed O(1) cotangents, added in another order
TRANSPOSE_RTOL, TRANSPOSE_ATOL = 1e-6, 1e-5
# coupled parity: at most this share of the columns may take another
# branch of a physics threshold in the card's f32 step than in the CPU's
FLIP_BOUND = 1e-3
# postphysics: relative change of global dry mass sum(delp (1 - qv) area)
DRY_MASS_BOUND = 1e-6
DENSE_DIR = "build/coupled_dense"
# BOUND_NOTE: a kernel's bound is the least time the card could take for
# the call: the larger of the bytes it must move (each input read once,
# each output written once) over the device memory rate and of its
# operations over the f32 rate outside the tensor cores (NVIDIA H100 SXM
# data sheet, at the full 700 W power limit; the card's own limit is
# printed beside).  Operations are counted from the kernels' sources, each
# add, multiply, divide, min/max, compare-select, power and logarithm as
# one, per cell (or column level) of the call's shapes (OPS_*); the
# remap's integration counts the (source, target) layer pairs that overlap
# in the call's own data.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_TP2D_CELL = 154  # hord 5: 2 inner half-updates of 54, 2 outer of 23
OPS_MULTI5_CELL = 5 * OPS_TP2D_CELL + 2  # + the air mass area * delp
OPS_SIM1_LEVEL = 60  # three level recurrences (csrc/sim1.cu)
OPS_DEL4_CELL = 30  # two flux-form Laplacians and the update
OPS_COLUMN_LEVEL = 12  # prefix sum, pow and log at the interface, pi, pm
OPS_REMAP_LEVEL = 74  # edge spline sweeps (14) and limiter walk (60)
OPS_REMAP_PAIR = 27  # one overlapping (source, target) layer pair
OPS_REMAP_TARGET = 8  # constant extensions and the division


def say(*args):
    print(*args, flush=True)


def reset_counts():
    for w in WRAPPERS.values():
        w.launches = 0


def read_counts():
    return {k: w.launches for k, w in WRAPPERS.items()}


def check_counts(tag, launches, expected):
    say(f"{tag} kernel launches: {launches}")
    if launches != expected:
        raise AssertionError(f"{tag}: launches {launches} != {expected}")


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


def bound(ins, outs, ops):
    """(ms, "bytes" or "operations"): the call's bound (BOUND_NOTE)."""
    nbytes = sum(t.numel() * t.element_size() for t in (*ins, *outs))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def record(stats, name, N, err, fn, plain, ins, outs, ops, library=None):
    """Time a kernel's wrapper alone (fn), its plain version and, where
    one PyTorch call computes the same function, that call; with the
    bound of the call, into stats[(name, N)]."""
    b_ms, b_by = bound(ins, outs, ops)
    stats[(name, N)] = dict(
        max_abs_err=err, ms=cuda_ms(fn), plain_ms=cuda_ms(plain),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=None if library is None else cuda_ms(library),
    )


# --- phase 1 ----------------------------------------------------------------


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    say(card())
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")


# --- phase 2 ----------------------------------------------------------------


def phase_build():
    """Build the kernels; the compiler's register and spill report goes
    to a file beside the library, its summary to the output."""
    t0 = time.perf_counter()
    _build.library()
    path = _build.build_info["path"]
    say(f"build: {time.perf_counter() - t0:.1f} s -> {path}")
    log = _build.build_info["log"]
    with open(f"{path}.ptxas.log", "w") as f:
        f.write(log)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", log))
    say(f"ptxas: {len(regs)} kernels, at most {max(regs, default=0)} "
        f"registers a thread, {spills} bytes of spills "
        f"(report: {path}.ptxas.log)")


def phase_probe():
    """The toolchain probe path (K7, K8): one call of each through the
    probe's entry points, counted, then each against its plain version
    bit for bit, and timed."""
    x = torch.as_tensor(
        np.random.RandomState(0).randn(*probe.SHAPE).astype(np.float32),
        device="cuda",
    )
    reset_counts()
    ys = {"probe_affine": probe.affine(x), "probe_stencil": probe.stencil(x)}
    torch.cuda.synchronize()
    launches = read_counts()
    check_counts("probe", launches, LAUNCHES_PROBE)
    stats = {}
    # x * 2 + 1 in one PyTorch call (1 + x * 2); no single call computes
    # the periodic stencil
    one, two = (torch.tensor(v, device="cuda") for v in (1.0, 2.0))
    library = {"probe_affine": lambda: torch.addcmul(one, x, two)}
    for name, fn, plain in (
        ("probe_affine", probe.affine_cuda, probe.affine_plain),
        ("probe_stencil", probe.stencil_cuda, probe.stencil_plain),
    ):
        want = plain(x)
        if not torch.equal(ys[name], want):
            raise AssertionError(f"{name}: differs from its plain version")
        err = float((ys[name] - want).abs().max())
        record(stats, name, 256, err, lambda: fn(x), lambda: plain(x),
               [x], [want], 2 * x.numel(), library=library.get(name))
        say(f"{name} [256, 256]: bit for bit equal to plain")
    return launches, stats


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
                timed = args, got
    args, got = timed
    record(stats, "fv_tp_2d", N, max(errs), lambda: fv_tp_2d_cuda(*args),
           lambda: advection.fv_tp_2d_plain(*args), args[:8], got,
           OPS_TP2D_CELL * got[0].numel())


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
    record(stats, "sim1_solver", n + 2 * H, max(errs),
           lambda: sim1_solver_cuda(dt, *args),
           lambda: riemann.sim1_solver(dt, *args), args, got,
           OPS_SIM1_LEVEL * got[0].numel())


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
    # the kernel alone, on the pre-exchanged pair scalar_filter gives it
    args = (halo_exchange(q, H, fill="x"), halo_exchange(q, H, fill="y"),
            m.area_px, m.area_py, c, H)
    N = n + 2 * H
    record(stats, "del4_filter", N, err, lambda: del4_filter_cuda(*args),
           lambda: sw.scalar_filter_plain(q, m, c), args[:4], [got],
           OPS_DEL4_CELL * got.numel())
    say(f"del4 n={n}: scalar_filter (2 exchanges + kernel) "
        f"{cuda_ms(lambda: sw.scalar_filter(q, m, c)):.4f} ms")


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
    record(stats, "column_pressures", N, max(errs),
           lambda: cuda_column.column_pressures_cuda(dp, PTOP),
           lambda: cuda_column.column_pressures_plain(dp, PTOP), [dp], got,
           OPS_COLUMN_LEVEL * dp.numel())


def _remap_inputs(rng, n, stag, dev):
    """Seeded monotone columns as in tests/test_pallas_kernels.py:187-209
    (source edges from ptop to ~1e5 Pa, target edges sharing the column's
    end points, q = 1 + white noise), with both edge sets built from
    positive spacings as tests/test_remap.py::_edges builds them: sorted
    random edges coincide in f32 (a 0/0 layer) once there are ~1e6
    layers."""
    ny, nx = n + stag[0], n + stag[1]

    def edges(scale):
        w = np.cumsum(0.2 + rng.rand(6, NZ + 1, ny, nx), axis=1)
        return (w - w[:, :1]) / (w[:, -1:] - w[:, :1]) * scale

    ps = 1.0e5 * (1.0 + 0.02 * rng.rand(6, 1, ny, nx))
    pe1 = PTOP + edges(ps - PTOP)
    pe2 = PTOP + edges(ps - PTOP)
    q = 1.0 + rng.randn(6, NZ, ny, nx)
    return [torch.as_tensor(a.astype(np.float32), device=dev)
            for a in (q, pe1, pe2)]


def column_mass_error(q, pe1, pe2, *outs):
    """max |relative change of column mass| of each remapped output."""
    m1 = (q.double() * (pe1[:, 1:] - pe1[:, :-1]).double()).sum(1)
    dp2 = (pe2[:, 1:] - pe2[:, :-1]).double()
    return [float(((o.double() * dp2).sum(1) / m1 - 1.0).abs().max())
            for o in outs]


def overlap_pairs(pe1, pe2):
    """The number of (source, target) layer pairs that overlap (ov > 0,
    csrc/remap.cu) in these columns."""
    top, bot = pe1[:, :1], pe1[:, -1:]
    pc = torch.minimum(torch.maximum(pe2, top), bot)
    pairs = 0
    for k in range(pe1.shape[1] - 1):
        ov = (torch.minimum(pc[:, 1:], pe1[:, k + 1 : k + 2])
              - torch.maximum(pc[:, :-1], pe1[:, k : k + 1]))
        pairs += int((ov > 0).sum())
    return pairs


def check_remap(rng, n, dev, stats):
    """K5 against remap_levels_plain: cell-centred, u- and v-staggered
    shapes, iv 1/0/-1 at kord 9 and kord 10/17 at iv 1; column mass."""
    errs = []
    for stag in ((0, 0), (1, 0), (0, 1)):
        q, pe1, pe2 = _remap_inputs(rng, n, stag, dev)
        for iv, kord in ((1, 9), (0, 9), (-1, 9), (1, 10), (1, 17)):
            tag = f"remap n={n} stag={stag} iv={iv} kord={kord}"
            got = ppm_remap_cuda(q, pe1, pe2, iv, kord)
            want = remap.remap_levels_plain(q, pe1, pe2, iv, kord)
            # tolerance of the JAX kernel test (test_pallas_kernels.py:228)
            errs.append(check_close(tag, got, want, 2e-5, 2e-5))
            # column mass (test_pallas_kernels.py:233-245): 2e-4, plus
            # twice the plain version's own f32 error -- kord 17 has no
            # limiter, and on white-noise columns its parabolas reach
            # ~300x the layer means, whose f32 pieces then lose ~1e-5 of
            # the column mass in either form
            rel, rel_plain = column_mass_error(q, pe1, pe2, got, want)
            say(f"{tag}: column mass {rel:.3e} (plain {rel_plain:.3e})")
            if not rel <= 2e-4 + 2.0 * rel_plain:
                raise AssertionError(f"{tag}: column mass {rel:.3e}")
            del want
            if stag == (0, 0) and (iv, kord) == (1, 9):
                args = (q, pe1, pe2, iv, kord)
                ops = (OPS_REMAP_LEVEL * q.numel()
                       + OPS_REMAP_TARGET * got.numel()
                       + OPS_REMAP_PAIR * overlap_pairs(pe1, pe2))
                record(stats, "ppm_remap", n + 2 * H, 0.0,
                       lambda: ppm_remap_cuda(*args),
                       lambda: remap.remap_levels_plain(*args),
                       args[:3], [got], ops)
        del q, pe1, pe2
        torch.cuda.empty_cache()
    stats[("ppm_remap", n + 2 * H)]["max_abs_err"] = max(errs)


def _multi5_inputs(rng, N, dev):
    """The 16 fields and 2 areas of the D stage at K1's physical scaling
    (Courant numbers ~0.2, fluxes ~5% of the cell area, delp ~100): the
    inner updates' denominators area + div(flux) stay away from zero."""
    def r(*s):
        return torch.as_tensor(rng.randn(*s).astype(np.float32), device=dev)

    sh = (6, NZ, N, N)
    apx = 1.0 + 0.1 * torch.as_tensor(rng.rand(6, N, N).astype(np.float32),
                                      device=dev)
    apy = apx + 0.01
    dp = [100.0 + r(*sh).abs() for _ in range(2)]
    return (
        dp[0], dp[1], 300.0 + 10.0 * r(*sh), 300.0 + 10.0 * r(*sh),
        r(*sh), r(*sh), -100.0 + 5.0 * r(*sh), -100.0 + 5.0 * r(*sh),
        1e-4 * r(*sh), 1e-4 * r(*sh), 0.2 * r(*sh), 0.2 * r(*sh),
        0.05 * apx[:, None] * r(*sh), 0.05 * apy[:, None] * r(*sh),
        0.05 * apx[:, None] * r(*sh), 0.05 * apy[:, None] * r(*sh),
        apx, apy,
    )


def five_k1(*args):
    """The five transports as five K1 calls (the unfused substep)."""
    return advection.transports5(fv_tp_2d_cuda, *args)


def check_multi5(rng, N, dev, stats):
    args = _multi5_inputs(rng, N, dev)
    sl = np.s_[:, :, 2 : N - 2, 2 : N - 2]  # consumed faces
    names = "fxd fyd fxt fyt fxw fyw fxz fyz fxo fyo".split()
    errs, k1_err = [], 0.0
    for hord in (1, 5, 6, 8):
        got = fv_tp_2d_multi5_cuda(*args, hord)
        want = advection.fv_tp_2d_multi5_plain(*args, hord)
        five = five_k1(*args, hord)
        for name, g, w, f in zip(names, got, want, five):
            # K1's tolerance (the JAX kernel test's, test_pallas_kernels.py:46)
            errs.append(check_close(
                f"multi5 N={N} hord={hord} {name}", g, w, 1e-4, 1e-3, sl,
            ))
            d = float((g - f).abs().max())
            k1_err = max(k1_err, d)
            if d > FUSED_RTOL * float(f.abs().max()):
                raise AssertionError(
                    f"multi5 N={N} hord={hord} {name}: {d:.3e} from five "
                    f"K1 calls"
                )
    say(f"multi5 N={N}: max|K6 - five K1 calls| = {k1_err:.3e} "
        f"(bound {FUSED_RTOL} x max|field|)")
    record(stats, "fv_tp_2d_multi5", N, max(errs),
           lambda: fv_tp_2d_multi5_cuda(*args, 5),
           lambda: advection.fv_tp_2d_multi5_plain(*args, 5), args, got,
           OPS_MULTI5_CELL * got[0].numel())
    k1_ms = cuda_ms(lambda: five_k1(*args, 5))
    say(f"multi5 N={N}: five K1 calls {k1_ms:.4f} ms")


def phase_kernels():
    rng = np.random.RandomState(0)
    stats = {}
    for n in (12, 48, 192):
        N = n + 2 * H
        check_tp(rng, N, "cuda", stats)
        check_sim1(rng, n, "cuda", stats)
        check_filter(rng, n, "cuda", stats)
        check_column(rng, N, "cuda", stats)
        check_remap(rng, n, "cuda", stats)
        check_multi5(rng, N, "cuda", stats)
        torch.cuda.empty_cache()
    return stats


def report_kernels(stats):
    for (name, N), r in sorted(stats.items()):
        lib = r["library_ms"]
        say(f"kernel {name:17s} N={N:3d} max_abs_err={r['max_abs_err']:.3e} "
            f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.1%} of it) library "
            + ("none" if lib is None else f"{lib:.4f} ms"))


# --- phases 4 and 5 ---------------------------------------------------------


def stepper(g, device, dtype=torch.float32, dt_atmos=DT_ATMOS):
    return make_dycore_stepper(
        g, NZ, dt_atmos, k_split=1, n_split=6, hord=5, kord=9,
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
    """One C12 dt on the card with the fused transport off and on, each
    against the same CPU references (the CPU dt is the same with either
    setting: the plain fused form is the five plain transports)."""
    g = CubedSphereGrid.make(12, halo=H)
    refs = cpu_references(g, 12)
    run_gpu, _, _ = stepper(g, "cuda")
    phis = torch.zeros((6, 12, 12), device="cuda")
    for fused in (False, True):
        advection.set_fused_transport(fused)
        try:
            out_gpu = run_gpu(benchmark_state(12, NZ, PTOP, "cuda"), phis, 1)
        finally:
            advection.set_fused_transport(False)
        compare_states(f"C12x63 fused={fused}", out_gpu, *refs)


def dry_mass(state, m):
    return float((state.delp.double() / m.rarea.double()[:, None]).sum())


def phase_main_path():
    n = 48
    g = CubedSphereGrid.make(n, halo=H)
    run, m, _ = stepper(g, "cuda")
    state = benchmark_state(n, NZ, PTOP, "cuda")
    phis = torch.zeros((6, n, n), device="cuda")
    mass0 = dry_mass(state, m)

    reset_counts()
    first = run(state, phis, 1)  # one dt, the counted run (and warm-up)
    torch.cuda.synchronize()
    launches = read_counts()
    check_counts("C48x63 one dt", launches, LAUNCHES_PER_DT)
    s = timed_dts("C48x63", run, first, phis, n, steps=5)
    check_state("C48x63", s, m, mass0, 6)
    compare_states("C48x63", first, *cpu_references(g, n))
    return launches


def timed_dts(tag, run, s, phis, n, steps):
    """ms per dt, median of `steps` dts by CUDA events; the last state."""
    times = []
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
    say(f"{tag} ms/dt {ms:.3f} (median of {steps}: "
        f"{[round(t, 3) for t in times]}) "
        f"cell-substep-updates/s {updates:.4e}")
    return s


def check_state(tag, s, m, mass0, dts):
    """Finite state and global dry mass over the run."""
    for k, x in s._asdict().items():
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{tag}: non-finite {k}")
    rel = (dry_mass(s, m) - mass0) / mass0
    say(f"{tag} dry mass relative change over {dts} dt: {rel:.3e} "
        f"(bound {MASS_BOUND})")
    if not abs(rel) <= MASS_BOUND:
        raise AssertionError(f"{tag}: dry mass not conserved: {rel:.3e}")


def phase_c192_path():
    """The C192 x 63 step with the fused transport on (module docstring,
    phase 6)."""
    n = 192
    g = CubedSphereGrid.make(n, halo=H)
    run, m, _ = stepper(g, "cuda", dt_atmos=DT_C192)
    state = benchmark_state(n, NZ, PTOP, "cuda")
    phis = torch.zeros((6, n, n), device="cuda")
    mass0 = dry_mass(state, m)
    advection.set_fused_transport(True)
    try:
        reset_counts()
        fused = run(state, phis, 1)  # the counted dt (and warm-up)
        torch.cuda.synchronize()
        launches = read_counts()
        check_counts("C192x63 fused one dt", launches, LAUNCHES_PER_DT_FUSED)
        s = timed_dts("C192x63 fused", run, fused, phis, n, steps=5)
    finally:
        advection.set_fused_transport(False)
    check_state("C192x63 fused", s, m, mass0, 6)
    del s
    unfused = run(state, phis, 1)
    again = run(state, phis, 1)
    for k in fused._fields:
        a, b, c = (getattr(x, k) for x in (fused, unfused, again))
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        say(f"C192x63 {k:5s} max|field| {scale:.3e} max|fused-unfused| "
            f"{err:.3e} max|unfused-unfused| {float((b - c).abs().max()):.3e}"
            f" (bound {FUSED_BOUND} x max|field|)")
        if not bool(torch.isfinite(a).all()) or err > FUSED_BOUND * scale:
            raise AssertionError(f"C192x63 fused vs unfused {k}: {err:.3e}")
    return launches


# --- phase 7 ----------------------------------------------------------------


def phase_transposes():
    """Gather-form exchange transposes against autograd's scatter-add
    transpose of the plain gather, at C48 and C192 widths."""
    rng = np.random.RandomState(7)
    for n in (48, 192):
        for kind, fill in (("dgrid", ""), ("cgrid", "x"), ("cgrid", "y")):
            sa, sb = (
                ((n + 1, n), (n, n + 1)) if kind == "dgrid"
                else ((n, n + 1), (n + 1, n))
            )
            a, b = (torch.as_tensor(rng.randn(6, NZ, *s).astype(np.float32),
                                    device="cuda") for s in (sa, sb))
            public = (
                (lambda x, y: halo_mod.halo_exchange_dgrid(x, y, H))
                if kind == "dgrid" else
                (lambda x, y, f=fill: halo_mod.halo_exchange_cgrid(x, y, H, f))
            )
            out, vjp_new = torch.func.vjp(public, a, b)
            _, vjp_old = torch.func.vjp(
                lambda x, y, k=kind, f=fill:
                    halo_mod._staggered_exchange(x, y, k, H, f), a, b
            )
            ct = tuple(torch.randn_like(o) for o in out)
            got, want = vjp_new(ct), vjp_old(ct)
            tag = f"transpose C{n} {kind}{fill and '-' + fill}"
            err = max(
                check_close(f"{tag} {w}", g, r, TRANSPOSE_RTOL,
                            TRANSPOSE_ATOL)
                for w, g, r in zip("ab", got, want)
            )
            ms = cuda_ms(lambda: vjp_new(ct))
            plain = cuda_ms(lambda: vjp_old(ct))
            say(f"{tag}: max_abs_err={err:.3e} gather transpose {ms:.4f} ms "
                f"autograd (scatter-add) {plain:.4f} ms")
            del a, b, out, ct, got, want, vjp_new, vjp_old
        torch.cuda.empty_cache()


# --- phases 8 and 9 ---------------------------------------------------------


def coupled_step(n, device, dtype, state=None):
    """One coupled step of bench.py rung 3 at C<n> x 63 through the
    wrapper and CompiledTimeLoop; from `state` (a DycoreState) if given.
    Returns (state, total_precip, diagnostics) on the CPU in float64."""
    wm, model = coupled_bench.initialize(n, device, DENSE_DIR, dtype)
    mdl = wm.get_model()
    if state is not None:
        mdl.state = type(state)(
            *(x.to(device=device, dtype=mdl.dtype) for x in state)
        )
    loop = compiled_loop.CompiledTimeLoop(wm, ml_model=model)
    t0 = time.perf_counter()
    diags = loop.step()
    loop.block()
    say(f"C{n}x{NZ} coupled step {device} {dtype}: "
        f"{time.perf_counter() - t0:.1f} s")
    cpu = type(mdl.state)(*(x.double().cpu() for x in mdl.state))
    return (cpu, mdl.total_precip.double().cpu(),
            {k: q.data.double().cpu() for k, q in diags.items()})


def flipped_columns(d_a, d_b):
    """Columns [6, n, n] in which a physics threshold decided differently
    in two runs, read from their diagnostics: the shallow-convection
    trigger, Betts-Miller's precip > 0, and the PBL contiguity cumprod
    (a flip moves the PBL top by a whole layer; 1 m is far above f32
    roundoff of the heights).  The surface layer's rib < 0 switch is
    continuous (both branches give the neutral coefficient at rib = 0)
    and needs no mask."""
    return (
        (d_a["shallow_convection_active"] != d_b["shallow_convection_active"])
        | ((d_a["convective_precipitation"] > 0)
           != (d_b["convective_precipitation"] > 0))
        | ((d_a["planetary_boundary_layer_height"]
            - d_b["planetary_boundary_layer_height"]).abs() > 1.0)
    )


def _column_mask(mask, x):
    """The [6, n, n] column mask broadcast onto a field's layout (its
    last two axes cell-centred or D-grid staggered)."""
    m = mask
    if x.shape[-2] == m.shape[-2] + 1:  # u: edges j and j + 1 of cell j
        m = torch.nn.functional.pad(m, (0, 0, 0, 1)) | \
            torch.nn.functional.pad(m, (0, 0, 1, 0))
    if x.shape[-1] == m.shape[-1] + 1:  # v
        m = torch.nn.functional.pad(m, (0, 1)) | \
            torch.nn.functional.pad(m, (1, 0))
    if x.ndim == 4:
        m = m[:, None]
    if x.ndim == 5:
        m = m[None, :, None]
    return m.expand(x.shape)


def phase_coupled_parity():
    """One coupled C12 step on the card in f32 against the CPU in f32 and
    float64, from the same perturbed f32 state (module docstring, 8)."""
    n = 12
    wm, _ = coupled_bench.initialize(n, "cpu", DENSE_DIR, "float32")
    st = wm.get_model().state
    rng = np.random.RandomState(8)
    pt = st.pt + torch.as_tensor(rng.randn(*st.pt.shape).astype(np.float32))
    # humidity at a seeded relative humidity per column, up to 10%
    # supersaturated, so that the step condenses, rains and convects;
    # at most 20 g/kg (near the top the saturation value is not small)
    _, p = gfs.pressure_fields(st.delp, PTOP)
    rh = rng.uniform(0.5, 1.1, size=(6, 1, n, n)).astype(np.float32)
    q = st.q.clone()
    q[0] = (torch.as_tensor(rh) * gfs.qsat(
        wrapper.temperature_from_pt(st.delp, pt, st.q[0], PTOP), p
    )).clamp_max(0.02)
    st = st._replace(pt=pt, q=q)
    ref64 = coupled_step(n, "cpu", "float64", st)
    plain32 = coupled_step(n, "cpu", "float32", st)
    got = coupled_step(n, "cuda", "float32", st)
    flips = flipped_columns(got[2], plain32[2])
    nflip, ncol = int(flips.sum()), flips.numel()
    say(f"C12x63 coupled: {nflip} of {ncol} columns took another physics "
        f"branch on the card than on the CPU in f32 (bound {FLIP_BOUND})")
    if nflip > FLIP_BOUND * ncol:
        raise AssertionError(f"C12x63 coupled: {nflip} flipped columns")
    fields = dict(zip(got[0]._fields, zip(got[0], plain32[0], ref64[0])))
    fields["total_precip"] = (got[1], plain32[1], ref64[1])
    for k, arrays in fields.items():
        keep = ~_column_mask(flips, arrays[0])
        a, p, r = (torch.where(keep, x, 0.0) for x in arrays)
        scale = float(r.abs().max())
        e_cuda = float((a - r).abs().max())
        e_plain = float((p - r).abs().max())
        say(f"C12x63 coupled {k:12s} max|f64| {scale:.3e} max|cuda-f64| "
            f"{e_cuda:.3e} max|cpu32-f64| {e_plain:.3e}")
        bound = F32_FACTOR * e_plain + 1e-7 * scale
        if not bool(torch.isfinite(arrays[0]).all()) or e_cuda > bound:
            raise AssertionError(f"C12x63 coupled {k}: {e_cuda:.3e} > "
                                 f"{bound:.3e}")


def global_sum(x, area):
    """sum(x * area) over [6, nz, n, n] in float64."""
    return float((x.double() * area[:, None]).sum())


def phase_coupled_path():
    """bench.py rung 3 at C48 x 63 (module docstring, 9)."""
    n = 48
    wm, model = coupled_bench.initialize(n, "cuda", DENSE_DIR)
    mdl = wm.get_model()
    loop = compiled_loop.CompiledTimeLoop(wm, ml_model=model)
    area = torch.as_tensor(mdl.area, dtype=torch.float64, device="cuda")

    reset_counts()
    diags = loop.step()  # the counted step (and warm-up)
    torch.cuda.synchronize()
    launches = read_counts()
    check_counts("C48x63 coupled one step", launches, LAUNCHES_COUPLED)
    for k, q in diags.items():
        if k.endswith("_filled_frac") and float(q.data) != 0.0:
            raise AssertionError(f"C48x63 coupled: {k} = {float(q.data)}")
    times = []
    for _ in range(6):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        loop.step()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    ms = statistics.median(times)
    dt = mdl.config.dt_atmos
    say(f"C48x63 coupled ms/step {ms:.3f} (median of {len(times)}: "
        f"{[round(t, 3) for t in times]}) simulated years/day "
        f"{dt / (ms / 1e3) / 365.25:.4f}")

    _, stages = compiled_loop.build_compiled_step(mdl, model, split=True)
    stage_ms = {k: [] for k in stages}

    def timed(name, *args):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = stages[name](*args)
        t1.record()
        torch.cuda.synchronize()
        stage_ms[name].append(t0.elapsed_time(t1))
        return out

    st, tp = mdl.state, loop._on_device(mdl.total_precip)
    for _ in range(5):
        cosz, solcon = loop._astronomy()
        st1, _ = timed("dynamics", st, mdl.phis)
        st2, tp, _, _ = timed("physics", st1, loop._tsfc, tp, cosz, solcon)
        st3, d3 = timed("postphysics", st2)
        m0, m1 = global_sum(st.delp, area), global_sum(st1.delp, area)
        if not abs(m1 / m0 - 1.0) <= MASS_BOUND:
            raise AssertionError(f"dynamics stage mass {m1 / m0 - 1.0:.3e}")
        if not torch.equal(st2.delp, st1.delp):
            raise AssertionError("physics stage changed delp")
        d0 = global_sum(st2.delp * (1.0 - st2.q[0].double()), area)
        d1 = global_sum(st3.delp * (1.0 - st3.q[0].double()), area)
        if not abs(d1 / d0 - 1.0) <= DRY_MASS_BOUND:
            raise AssertionError(f"postphysics dry mass {d1 / d0 - 1.0:.3e}")
        if any(float(v) != 0.0 for k, v in d3.items()
               if k.endswith("_filled_frac")):
            raise AssertionError("postphysics filled NaN predictions")
        st = st3
    say(f"C48x63 coupled stages: dynamics mass {m1 / m0 - 1.0:.3e} "
        f"(bound {MASS_BOUND}), physics delp bit for bit, postphysics dry "
        f"mass {d1 / d0 - 1.0:.3e} (bound {DRY_MASS_BOUND}), filled 0")
    for k, v in stage_ms.items():
        say(f"C48x63 coupled stage {k:11s} ms {statistics.median(v):.3f} "
            f"(median of {len(v)}: {[round(t, 3) for t in v]})")
    for k, x in st._asdict().items():
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"C48x63 coupled: non-finite {k}")
    return launches


def kernel_summary(stats, probe_launches, fused_launches,
                   coupled_launches):
    """The kernels' JSON entries: each kernel's launches from the path
    that runs it (K1-K5 from the coupled C48 path, K6 from the C192 path)
    and its phase-3 numbers at that path's shapes (the probes at theirs);
    prints launches x (time - bound) of each kernel on each path."""
    counted = dict(coupled_launches,
                   fv_tp_2d_multi5=fused_launches["fv_tp_2d_multi5"],
                   probe_affine=probe_launches["probe_affine"],
                   probe_stencil=probe_launches["probe_stencil"])
    shape = dict({k: 54 for k in META}, fv_tp_2d_multi5=198,
                 probe_affine=256, probe_stencil=256)
    kernels = []
    for name, (source, replaces) in META.items():
        r = stats[(name, shape[name])]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counted[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    for tag, launches, N in (("C48", LAUNCHES_PER_DT, 54),
                             ("coupled C48", coupled_launches, 54),
                             ("C192 fused", fused_launches, 198)):
        loss = {
            k: round(n * (stats[(k, N)]["ms"] - stats[(k, N)]["bound_ms"]), 4)
            for k, n in launches.items() if n and (k, N) in stats
        }
        say(f"{tag}: launches x (kernel ms - bound ms) per step {loss}")
    return kernels


def main():
    phase_device()
    phase_build()
    probe_launches, stats = phase_probe()
    stats.update(phase_kernels())
    report_kernels(stats)
    phase_slice_parity()
    phase_main_path()
    fused_launches = phase_c192_path()
    phase_transposes()
    os.makedirs(os.path.dirname(DENSE_DIR), exist_ok=True)
    phase_coupled_parity()
    coupled_launches = phase_coupled_path()
    kernels = kernel_summary(stats, probe_launches, fused_launches,
                             coupled_launches)
    say(card())
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
