"""Design experiments on the GPU: variants of the K1 transport kernel
(``csrc/tp2d.cu``), the level runs of K1 and K3 (``csrc/filter.cu``), the
tile widths and the split of the column kernels K2 (``csrc/sim1.cu``) and
K4 (``csrc/column.cu``), and builds without FMA contraction, timed or
compared in turns in one process on one card.

Run on the GPU machine from the repository root:

    python -m fv3net_tpu_torch.kernel_variants [--reps 2]
        [--only k1,k3,slab,fmad] [--parent DIR] [--k3-parent FILE]

Each K1 variant is ``csrc/tp2d.cu`` with its tile (TX x TY), its threads a
block and its blocks an SM changed, or with the 8-byte copies off (4-byte
copies), or with the shared-memory phases off (``copies``: the copies and
barriers alone, nothing stored) or with the copies after a run's first
level off (``phases``: the phases alone, on stale tiles).  Each variant is
compiled by its own ``nvcc`` into ``build/variants/<name>.so``, all started
together, and its C entry point is called directly with runs of 1, 2, 4
and 8 levels a block, at N = 54 and 198 x 63 levels (the C48 and C192
widths), hord 5 and hord 1, on seeded inputs with plain areas; the
variants that compute (not ``copies`` or ``phases``) are checked bit for
bit against the package's own K1 wrapper.  K3, from the package's build,
is timed with runs of 1-16 levels at n = 48 and 192.  Times are CUDA
events, median of 20 launches of the C entry point alone (no wrapper, so
no host time).

K2 and K4 (``slab``): each variant is the kernel's source with its tile
width TC (columns a block) or threads a block changed, or with part of the work switched off: ``copies`` (the copies in and the
stores out alone), ``compute`` (all arithmetic on slabs filled in shared
memory, nothing copied), and for K2 ``phases`` (the level-parallel
arithmetic alone) and ``recurrences`` (the per-column recurrences
alone).  K2 runs at n = 48 and 192
on chip_smoke.py's plausible columns with pem, pm and ws halo-padded as
the step passes them, K4 on dp [6, 63, N, N] at N = 54 and 198; the full
variants are compared with the package's wrappers (bit for bit, else the
max abs difference).

``fmad``: K2, K4 and K3 built with ``-fmad=false`` (nvcc contracts no
multiply-add into an FMA) beside the default build, and the same for the
sources of another checkout (``--parent``, whose K2 may be the one-thread-
a-column kernel with its global scratch) and for an older K3 source
(``--k3-parent``, a ``filter.cu`` whose ``fv3_del4`` takes the x- and
y-fill exchanges, a scratch and the output).  Each pair is compared (bit
for bit, else the max abs difference): where two sources differ in the
default build and agree without contraction, the difference is how nvcc
contracted each, not the arithmetic.  Prints one JSON line per
measurement, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
from pathlib import Path

import numpy as np

from .constants import CP_AIR, CV_AIR, RDGAS
from .constants import REFERENCE_SURFACE_PRESSURE as P00
from .constants import KAPPA
from .kernel_times import H, PTOP, _halo_padded, _sim1_inputs
from .ops import _build

NZ = 63
# name: (TX, TY, threads, min blocks an SM, mode); the first is the
# package's own configuration
K1_VARIANTS = {
    "33x18 t256": (33, 18, 256, 3, "full"),
    "33x18 t256 4-byte": (33, 18, 256, 3, "four_byte"),
    "33x18 t256 copies": (33, 18, 256, 3, "copies"),
    "33x18 t256 phases": (33, 18, 256, 3, "phases"),
    "33x33 t384": (33, 33, 384, 2, "full"),
    "33x33 t256": (33, 33, 256, 2, "full"),
    "54x18 t384": (54, 18, 384, 2, "full"),
}
LEVEL_RUNS = (1, 2, 4, 8)
LOOPS = "    for (int t = threadIdx.x;"  # the five phase loops of the kernel
NEXT = "    if (k + 1 < k1)\n      issue("  # the next level's copies


def variant_source(src: str, tx: int, ty: int, threads: int, blocks: int,
                   mode: str) -> str:
    """csrc/tp2d.cu's source with the tile, threads, blocks an SM and mode
    of a variant; raises if the source no longer has a line it changes."""
    edits = [
        (r"constexpr int TX = \d+;", f"constexpr int TX = {tx};"),
        (r"constexpr int TY = \d+;", f"constexpr int TY = {ty};"),
        (r"constexpr int kThreads = \d+;",
         f"constexpr int kThreads = {threads};"),
        (r"__launch_bounds__\(kThreads, \d+\)",
         f"__launch_bounds__(kThreads, {blocks})"),
    ]
    if mode == "four_byte":
        edits.append((re.escape("bool pairs = N % 2 == 0;"),
                      "bool pairs = false;"))
    elif mode == "copies":
        edits.append((re.escape(LOOPS),
                      "    if (false) for (int t = threadIdx.x;"))
    elif mode == "phases":
        edits.append((re.escape(NEXT), "    if (false)\n      issue("))
    elif mode != "full":
        raise ValueError(f"unknown mode {mode}")
    for pattern, new in edits:
        src, count = re.subn(pattern, new, src)
        if count == 0:
            raise ValueError(f"csrc/tp2d.cu has no {pattern!r}")
    return src


# K2 and K4 (csrc/sim1.cu, csrc/column.cu): name: (the integer constants
# a variant changes, the switches it turns off); the first of each is the
# package's own configuration.  TC: columns a tile; kThreads: threads a
# block.
_K2 = dict(TC=32, kThreads=512)
_K4 = dict(TC=32, kThreads=128)
SLAB_VARIANTS = {
    "sim1.cu": {
        "TC32 t512": (_K2, ()),
        "TC32 t256": (dict(_K2, kThreads=256), ()),
        "TC32 t128": (dict(_K2, kThreads=128), ()),
        "TC16 t256": (dict(_K2, TC=16, kThreads=256), ()),
        "TC64 t512": (dict(_K2, TC=64), ()),
        "TC32 t512 copies": (_K2, ("kPhases", "kRecurrences")),
        "TC32 t512 phases": (_K2, ("kMemory", "kRecurrences")),
        "TC32 t512 recurrences": (_K2, ("kMemory", "kPhases")),
        "TC32 t512 compute": (_K2, ("kMemory",)),
    },
    "column.cu": {
        "TC32 t128": (_K4, ()),
        "TC16 t128": (dict(_K4, TC=16), ()),
        "TC32 t64": (dict(_K4, kThreads=64), ()),
        "TC32 t256": (dict(_K4, kThreads=256), ()),
        "TC64 t256": (dict(_K4, TC=64, kThreads=256), ()),
        "TC32 t128 copies": (_K4, ("kCompute",)),
        "TC32 t128 compute": (_K4, ("kMemory",)),
    },
}
# the C entry point's argument types of a K2 with its global scratch (the
# one-thread-a-column kernel: pp and gam after ppe, n * n for n and h)
OLD_SIM1_SIGNATURE = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 3
                      + [ctypes.c_float] * 6 + [ctypes.c_void_p])
# the C entry point's argument types of a K3 that takes the exchanges
OLD_DEL4_SIGNATURE = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                      + [ctypes.c_float] + [ctypes.c_void_p])


def slab_variant_source(src: str, ints: dict, off=()) -> str:
    """A column kernel's source with the integer constants `ints` and the
    switches `off` turned off; raises if the source lacks one of them."""
    edits = [(rf"constexpr int {k} = \d+;", f"constexpr int {k} = {v};")
             for k, v in ints.items()]
    edits += [(re.escape(f"constexpr bool {k} = true;"),
               f"constexpr bool {k} = false;") for k in off]
    for pattern, new in edits:
        src, count = re.subn(pattern, new, src)
        if count == 0:
            raise ValueError(f"no {pattern!r} in the source")
    return src


def _compile(jobs, out: Path):
    """Compile each job (name, source text, include dir, extra nvcc flags,
    C entry point, argtypes) into its own library, one nvcc each, all
    started together; returns {name: (C entry point, registers, spill
    bytes)}."""
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {}
    for i, (name, src, inc, flags, entry, argtypes) in enumerate(jobs):
        cu = out / f"variant_{i}.cu"
        cu.write_text(src)
        procs[name] = (i, entry, argtypes, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *flags, "-I", str(inc), "-shared",
             "-o", str(out / f"variant_{i}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    libs = {}
    for name, (i, entry, argtypes, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        fn = getattr(ctypes.CDLL(str(out / f"variant_{i}.so")), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        regs = max(int(r) for r in re.findall(r"Used (\d+) registers", log))
        spill = sum(int(b) for b in re.findall(r"(\d+) bytes spill", log))
        libs[name] = (fn, regs, spill)
    return libs


def _k1_jobs():
    src = (_build.CSRC / "tp2d.cu").read_text()
    return [(name, variant_source(src, *v), _build.CSRC, (), "fv3_tp2d",
             _build.SIGNATURES["fv3_tp2d"])
            for name, v in K1_VARIANTS.items()]


def _slab_jobs():
    jobs = []
    for file, variants in SLAB_VARIANTS.items():
        src = (_build.CSRC / file).read_text()
        entry = "fv3_sim1" if file == "sim1.cu" else "fv3_column"
        for name, v in variants.items():
            jobs.append((f"{file} {name}", slab_variant_source(src, *v),
                         _build.CSRC, (), entry, _build.SIGNATURES[entry]))
    return jobs


def _fmad_jobs(parent, k3_parent):
    """K2, K4 and K3 of the package, of --parent and --k3-parent, each
    built with and without FMA contraction."""
    jobs = []
    sources = [("change", _build.CSRC, f) for f in
               ("sim1.cu", "column.cu", "filter.cu")]
    if parent:
        csrc = Path(parent) / "fv3net_tpu_torch" / "csrc"
        sources += [("parent", csrc, f) for f in ("sim1.cu", "column.cu")]
    if k3_parent:
        sources.append(("k3_parent", Path(k3_parent).parent,
                        Path(k3_parent).name))
    for tree, csrc, file in sources:
        src = (csrc / file).read_text()
        entry = {"sim1.cu": "fv3_sim1", "column.cu": "fv3_column",
                 "filter.cu": "fv3_del4"}[file]
        argtypes = _build.SIGNATURES[entry]
        if entry == "fv3_sim1" and "float* gam" in src:
            argtypes = OLD_SIM1_SIGNATURE
        if tree == "k3_parent":
            argtypes = OLD_DEL4_SIGNATURE
        for fmad in (True, False):
            flags = () if fmad else ("-fmad=false",)
            jobs.append((f"{tree} {file} fmad={str(fmad).lower()}", src,
                         csrc, flags, entry, argtypes))
    return jobs


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


def _say(**kw):
    print(json.dumps(kw), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2,
                    help="turns over all variants")
    ap.add_argument("--only", default="k1,k3,slab,fmad",
                    help="comma-separated parts: k1, k3, slab, fmad")
    ap.add_argument("--parent", help="another checkout's root (fmad)")
    ap.add_argument("--k3-parent",
                    help="a filter.cu that takes the exchanges (fmad)")
    args = ap.parse_args(argv)
    parts = set(args.only.split(","))
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_variants needs a CUDA device")
    jobs = ((_k1_jobs() if "k1" in parts else [])
            + (_slab_jobs() if "slab" in parts else [])
            + (_fmad_jobs(args.parent, args.k3_parent)
               if "fmad" in parts else []))
    libs = _compile(jobs, Path(_build.BUILD_DIR).parent / "variants")
    for name, (_, regs, spill) in libs.items():
        _say(variant=name, registers=regs, spill_bytes=spill)
    if "k1" in parts:
        _k1(torch, libs, args.reps)
    if "k3" in parts:
        _k3(torch, args.reps)
    if "slab" in parts:
        _slab(torch, libs, args.reps)
    if "fmad" in parts:
        _fmad(torch, libs)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)


def _k1(torch, libs, reps):
    """K1's variants at N = 54 and 198, level runs 1-8, hord 5 and 1."""
    from .ops.cuda_tp import fv_tp_2d_cuda

    stream = _build.stream()
    for N in (54, 198):
        rng = np.random.RandomState(N)
        sh = (6, NZ, N, N)
        area = 1.0 + 0.1 * rng.rand(6, 1, N, N)
        ins = [torch.as_tensor(a.astype(np.float32), device="cuda") for a in (
            rng.randn(*sh), rng.randn(*sh), 0.2 * rng.randn(*sh),
            0.2 * rng.randn(*sh), 0.05 * area * rng.randn(*sh),
            0.05 * area * rng.randn(*sh), area, area + 0.01)]
        ptrs = [t.data_ptr() for t in ins]
        fx, fy = torch.empty(sh, device="cuda"), torch.empty(sh, device="cuda")
        want = fv_tp_2d_cuda(*ins, 5)
        for rep in range(reps):
            for name in K1_VARIANTS:
                fn = libs[name][0]
                for lv in LEVEL_RUNS:
                    for hord in (5, 1):
                        def run(fn=fn, lv=lv, hord=hord):
                            err = fn(
                                *ptrs, N * N, 0, fx.data_ptr(),
                                fy.data_ptr(), 6, NZ, N, hord, lv, stream)
                            if err != 0:
                                raise RuntimeError(f"{name}: error {err}")

                        run()
                        same = None
                        if hord == 5 and K1_VARIANTS[name][4] in (
                                "full", "four_byte"):
                            torch.cuda.synchronize()
                            same = (torch.equal(fx, want[0])
                                    and torch.equal(fy, want[1]))
                            if not same:
                                raise AssertionError(
                                    f"{name} lv={lv} differs from K1")
                        _say(kernel="fv_tp_2d", N=N, variant=name,
                             levels=lv, hord=hord, turn=rep,
                             ms=_cuda_ms(torch, run), equal_to_k1=same)
        del ins, fx, fy, want


def _k3(torch, reps):
    """K3 (the package's build) with runs of 1-16 levels at n = 48, 192."""
    from .grid import halo as halo_mod

    lib = _build.library()
    stream = _build.stream()
    for n in (48, 192):
        rng = np.random.RandomState(n)
        q = torch.as_tensor(rng.randn(6, NZ, n, n).astype(np.float32),
                            device="cuda")
        area = torch.as_tensor((1.0 + 0.1 * rng.rand(6, n, n)).astype(
            np.float32), device="cuda")
        apx = halo_mod.halo_exchange(area, 3, fill="x")
        apy = halo_mod.halo_exchange(area, 3, fill="y")
        tx, ty = (halo_mod.scalar_gather_flat(n, 3, NZ, f, q.device)
                  for f in ("x", "y"))
        out = torch.empty_like(q)
        for rep in range(reps):
            for lv in (1, 2, 4, 8, 16):
                def run(lv=lv):
                    err = lib.fv3_del4(
                        q.data_ptr(), tx.data_ptr(), ty.data_ptr(),
                        apx.data_ptr(), apy.data_ptr(), out.data_ptr(), 6,
                        NZ, n, 3, lv, 0.0025, stream)
                    if err != 0:
                        raise RuntimeError(f"fv3_del4: error {err}")

                _say(kernel="del4_filter", n=n, levels=lv, turn=rep,
                     ms=_cuda_ms(torch, run))


def _sim1_case(torch, n):
    """K2's inputs at n (pem, pm, ws halo-padded) and output buffers."""
    inner = [torch.as_tensor(a, device="cuda")
             for a in _sim1_inputs(np.random.RandomState(n), n)]
    padded = inner[:4] + [_halo_padded(torch, a) for a in inner[4:]]
    outs = [torch.empty_like(inner[0]), torch.empty_like(inner[0]),
            torch.empty((6, NZ + 1, n, n), device="cuda")]
    return inner, padded, outs


SIM1_CONSTS = (RDGAS, P00, CP_AIR / CV_AIR, -CV_AIR / CP_AIR)


def _call_sim1(fn, ins, outs, n, h, stream, scratch=None):
    """One launch of a K2 entry point; `scratch` (pp, gam) for the one
    with its global scratch, which takes n * n for n and no halo."""
    ptrs = [t.data_ptr() for t in (*ins, *outs)]
    if scratch is None:
        err = fn(*ptrs, 6, NZ, n, h, 150.0, 0.05, *SIM1_CONSTS, stream)
    else:
        err = fn(*ptrs, *(t.data_ptr() for t in scratch), 6, NZ, n * n,
                 150.0, 0.05, *SIM1_CONSTS, stream)
    if err != 0:
        raise RuntimeError(f"fv3_sim1: error {err}")


def _call_column(fn, dp, outs, stream):
    N = dp.shape[-1]
    err = fn(dp.data_ptr(), *(t.data_ptr() for t in outs), 6, NZ, N * N,
             PTOP, P00, KAPPA, stream)
    if err != 0:
        raise RuntimeError(f"fv3_column: error {err}")


def _slab(torch, libs, reps):
    """K2 and K4's tile widths and split, in turns."""
    from .ops.cuda_column import column_pressures_cuda
    from .ops.cuda_sim1 import sim1_solver_cuda

    stream = _build.stream()
    for n in (48, 192):
        inner, padded, outs = _sim1_case(torch, n)
        want = sim1_solver_cuda(150.0, *padded, halo=H)
        N = n + 2 * H
        dp = torch.as_tensor((900.0 + 200.0 * np.random.RandomState(N).rand(
            6, NZ, N, N)).astype(np.float32), device="cuda")
        col_outs = [torch.empty((6, NZ + 1, N, N), device="cuda"),
                    torch.empty_like(dp), torch.empty_like(dp)]
        col_want = column_pressures_cuda(dp, PTOP)
        for rep in range(reps):
            for file, variants in SLAB_VARIANTS.items():
                for name, (_, off) in variants.items():
                    fn = libs[f"{file} {name}"][0]
                    if file == "sim1.cu":
                        def run(fn=fn):
                            _call_sim1(fn, padded, outs, n, H, stream)
                        got, ref, width = outs, want, n
                    else:
                        def run(fn=fn):
                            _call_column(fn, dp, col_outs, stream)
                        got, ref, width = col_outs, col_want, N
                    run()
                    torch.cuda.synchronize()
                    same = None if off else _diff(got, ref)
                    _say(kernel=file, width=width, variant=name, turn=rep,
                         ms=_cuda_ms(torch, run), against_package=same)
        del inner, padded, outs, want, dp, col_outs, col_want


def _diff(a, b):
    """'bit for bit', else the max abs difference of two output lists."""
    if all(x.shape == y.shape and bool((x == y).all()) for x, y in zip(a, b)):
        return "bit for bit"
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


FMAD_TREES = ("change", "parent", "k3_parent")


def _fmad(torch, libs):
    """Each K2, K4 and K3 build of each tree with and without FMA
    contraction on the same inputs, compared pairwise."""
    from .grid import halo as halo_mod

    stream = _build.stream()
    results = {}
    for n in (48, 192):
        N = n + 2 * H
        inner, padded, _ = _sim1_case(torch, n)
        dp = torch.as_tensor((900.0 + 200.0 * np.random.RandomState(N).rand(
            6, NZ, N, N)).astype(np.float32), device="cuda")
        q = torch.as_tensor(np.random.RandomState(n).randn(
            6, NZ, n, n).astype(np.float32), device="cuda")
        area = torch.as_tensor((1.0 + 0.1 * np.random.RandomState(n + 1).rand(
            6, n, n)).astype(np.float32), device="cuda")
        apx = halo_mod.halo_exchange(area, H, fill="x")
        apy = halo_mod.halo_exchange(area, H, fill="y")
        tabs = [halo_mod.scalar_gather_flat(n, H, NZ, f, q.device)
                for f in ("x", "y")]
        qx, qy = (halo_mod.halo_exchange(q, H, fill=f) for f in ("x", "y"))
        c8 = 0.02 / 8.0  # sw.FILTER_COEF / 8
        for name, (fn, _, _) in libs.items():
            if not name.endswith(("fmad=true", "fmad=false")):
                continue
            tree, file, _ = name.split(" ")
            if file == "sim1.cu":
                outs = [torch.empty_like(inner[0]), torch.empty_like(inner[0]),
                        torch.empty((6, NZ + 1, n, n), device="cuda")]
                if list(fn.argtypes) == OLD_SIM1_SIGNATURE:
                    scratch = [torch.empty_like(outs[2]),
                               torch.empty_like(outs[0])]
                    _call_sim1(fn, inner, outs, n, 0, stream, scratch)
                else:
                    _call_sim1(fn, padded, outs, n, H, stream)
            elif file == "column.cu":
                outs = [torch.empty((6, NZ + 1, N, N), device="cuda"),
                        torch.empty_like(dp), torch.empty_like(dp)]
                _call_column(fn, dp, outs, stream)
            elif tree == "k3_parent":
                l1 = torch.empty_like(qx)
                outs = [torch.empty_like(q)]
                err = fn(qx.data_ptr(), qy.data_ptr(), apx.data_ptr(),
                         apy.data_ptr(), l1.data_ptr(), outs[0].data_ptr(),
                         6, NZ, N, H, c8, stream)
                if err != 0:
                    raise RuntimeError(f"{name}: error {err}")
            else:
                outs = [torch.empty_like(q)]
                err = fn(q.data_ptr(), tabs[0].data_ptr(),
                         tabs[1].data_ptr(), apx.data_ptr(), apy.data_ptr(),
                         outs[0].data_ptr(), 6, NZ, n, H, 1, c8, stream)
                if err != 0:
                    raise RuntimeError(f"{name}: error {err}")
            torch.cuda.synchronize()
            results[(n, name)] = outs
        files = sorted({name.split(" ")[1] for _, name in results})
        for file in files:
            for fmad in ("fmad=true", "fmad=false"):
                trees = [t for t in FMAD_TREES
                         if f"{t} {file} {fmad}" in
                         {name for _, name in results}]
                for i, t1 in enumerate(trees):
                    for t2 in trees[i + 1:]:
                        _say(compare=f"{file} {t1} vs {t2}", n=n, build=fmad,
                             diff=_diff(results[(n, f"{t1} {file} {fmad}")],
                                        results[(n, f"{t2} {file} {fmad}")]))
            for t in FMAD_TREES:
                key = (n, f"{t} {file} fmad=true")
                if key in results:
                    _say(compare=f"{file} {t} default vs -fmad=false", n=n,
                         diff=_diff(results[key],
                                    results[(n, f"{t} {file} fmad=false")]))
        results = {}


if __name__ == "__main__":
    main()
