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
     times (median of 20 calls) of kernel and plain version; K6 also
     against five K1 calls;
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
Launch counts are read per path: K7/K8 on the probe path, K1-K5 on the
C48 main path, K6 on the C192 path.  The last two lines are the kernels'
JSON summary and {"ok": true, "device": {...}}.
"""

import json
import re
import statistics
import subprocess
import time
import types

import numpy as np
import torch

from fv3net_tpu_torch import probe
from fv3net_tpu_torch.constants import GRAV
from fv3net_tpu_torch.dycore import riemann, sw
from fv3net_tpu_torch.dycore.hydro import benchmark_state, make_dycore_stepper
from fv3net_tpu_torch.grid import CubedSphereGrid, halo_exchange
from fv3net_tpu_torch.ops import _build, advection, cuda_column, remap
from fv3net_tpu_torch.ops.cuda_filter import del4_filter_cuda
from fv3net_tpu_torch.ops.cuda_remap import ppm_remap_cuda
from fv3net_tpu_torch.ops.cuda_sim1 import sim1_solver_cuda
from fv3net_tpu_torch.ops.cuda_tp import fv_tp_2d_cuda, fv_tp_2d_multi5_cuda

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
                     "tools/probe_pallas.py:12"),
    "probe_stencil": ("fv3net_tpu_torch/csrc/probe.cu",
                      "tools/probe_pallas.py:33"),
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
    for name, fn, plain in (
        ("probe_affine", probe.affine_cuda, probe.affine_plain),
        ("probe_stencil", probe.stencil_cuda, probe.stencil_plain),
    ):
        want = plain(x)
        if not torch.equal(ys[name], want):
            raise AssertionError(f"{name}: differs from its plain version")
        err = float((ys[name] - want).abs().max())
        stats[(name, 256)] = (err, cuda_ms(lambda: fn(x)),
                              cuda_ms(lambda: plain(x)))
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
                ms = cuda_ms(lambda: ppm_remap_cuda(*args))
                plain = cuda_ms(lambda: remap.remap_levels_plain(*args))
        del q, pe1, pe2
        torch.cuda.empty_cache()
    stats[("ppm_remap", n + 2 * H)] = (max(errs), ms, plain)


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
    ms = cuda_ms(lambda: fv_tp_2d_multi5_cuda(*args, 5))
    plain = cuda_ms(lambda: advection.fv_tp_2d_multi5_plain(*args, 5))
    k1_ms = cuda_ms(lambda: five_k1(*args, 5))
    say(f"multi5 N={N}: five K1 calls {k1_ms:.4f} ms")
    stats[("fv_tp_2d_multi5", N)] = (max(errs), ms, plain)


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
    for (name, N), (err, ms, plain) in sorted(stats.items()):
        say(f"kernel {name:17s} N={N:3d} max_abs_err={err:.3e} "
            f"kernel {ms:.4f} ms plain {plain:.4f} ms")
    return stats


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


def main():
    phase_device()
    phase_build()
    probe_launches, stats = phase_probe()
    stats.update(phase_kernels())
    phase_slice_parity()
    launches = phase_main_path()
    fused_launches = phase_c192_path()
    # each kernel's launches from the path that runs it; times and errors
    # at the C48 main path's shapes (the probes at theirs)
    counted = dict(launches, fv_tp_2d_multi5=fused_launches["fv_tp_2d_multi5"],
                   probe_affine=probe_launches["probe_affine"],
                   probe_stencil=probe_launches["probe_stencil"])
    kernels = []
    for name, (source, replaces) in META.items():
        err, ms, plain = stats[(name, 256 if name.startswith("probe") else 54)]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counted[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
        })
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
