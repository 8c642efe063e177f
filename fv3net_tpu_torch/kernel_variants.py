"""Design experiments on the GPU: variants of the K1 transport kernel
(``csrc/tp2d.cu``) and the level runs of K1 and K3 (``csrc/filter.cu``),
timed in turns in one process on one card.

Run on the GPU machine from the repository root:

    python -m fv3net_tpu_torch.kernel_variants [--reps 2]

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
no host time).  Prints one JSON line per measurement, then the card's
name and power limit.
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


def _build_variants(out: Path):
    """Compile every K1 variant, one nvcc each, all started together;
    returns {name: (ctypes library, registers, spill bytes)}."""
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "tp2d.cu").read_text()
    nvcc = _build.find_nvcc()
    procs = {}
    for i, (name, v) in enumerate(K1_VARIANTS.items()):
        cu = out / f"tp2d_{i}.cu"
        cu.write_text(variant_source(src, *v))
        procs[name] = (i, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
             "-o", str(out / f"tp2d_{i}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    libs = {}
    for name, (i, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out / f"tp2d_{i}.so"))
        lib.fv3_tp2d.argtypes = _build.SIGNATURES["fv3_tp2d"]
        lib.fv3_tp2d.restype = ctypes.c_int
        regs = max(int(r) for r in re.findall(r"Used (\d+) registers", log))
        spill = sum(int(b) for b in re.findall(r"(\d+) bytes spill", log))
        libs[name] = (lib, regs, spill)
    return libs


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
    args = ap.parse_args(argv)
    import torch

    from .grid import halo as halo_mod
    from .ops.cuda_tp import fv_tp_2d_cuda

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_variants needs a CUDA device")
    libs = _build_variants(Path(_build.BUILD_DIR).parent / "variants")
    for name, (_, regs, spill) in libs.items():
        _say(variant=name, registers=regs, spill_bytes=spill)
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
        for rep in range(args.reps):
            for name, (lib, _, _) in libs.items():
                for lv in LEVEL_RUNS:
                    for hord in (5, 1):
                        def run(lib=lib, lv=lv, hord=hord):
                            err = lib.fv3_tp2d(
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
    lib = _build.library()
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
        for rep in range(args.reps):
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
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
