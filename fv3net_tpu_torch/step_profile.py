"""Where the time of one C48 (or C192) x 63 dycore dt, of one coupled
C48 step, or of one step of the eager prognostic run or of the nudged run
at C48, goes on the GPU.

Run on the GPU machine from the repository root:

    python -m fv3net_tpu_torch.step_profile [--n 48|192] [--fused]
                                            [--coupled | --prognostic
                                             | --nudged] [--out DIR]

Builds the benchmark configuration (bench.py ``_build_config``: C<n> x 63,
k_split=1, n_split=6, hord=5, kord=9, f32; dt_atmos 900 s at C48 and
225 s at C192, bench.py's rung 2), with the fused 5-field transport
(``ops.advection.set_fused_transport``) on if --fused; or with --coupled
the coupled step of bench.py rung 3 (``runtime.coupled_bench``: the
dycore + radiation + GFS physics + dense ML corrector, C48 only, its
three stages labelled in the traced steps); or with --prognostic one
step of the eager TimeLoop over the wrapper's phases (the default model:
hydrostatic C48 x 63, simple suite, f32, from the wrapper's initial
state; C48 only, its substeps labelled); or with --nudged one step of the
nudged run (``runtime.nudged_case``: the wrapper initialised from restart
files of a seeded moist state, nonhydrostatic, GFS suite with GFDL
microphysics over six advected species, the nudger of T and humidity
toward two snapshots; C48 only, its substeps labelled).  Warms up one
dt, then:
  * times 5 dts with the host clock (synchronized), the step time a user
    sees;
  * traces 2 dts with torch.profiler (CPU + CUDA activities) and reports
    the device-busy time per dt (sum of kernel times), hence the device
    idle share, the number of kernel launches per dt, the copies per dt
    (torch's copy kernels and memcpy activities), the kernels by device
    time, and the host time of the dycore's stages (each stage wrapped in
    a record_function label for the traced dts only).
Writes ``step_profile_c<n>[_fused|_coupled|_prognostic|_nudged].json`` and
``.txt`` under
--out and prints the JSON summary.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import wrapper
from .dycore import hydro
from .grid import CubedSphereGrid
from .ops import advection
from .runtime import compiled_loop, coupled_bench, derived_state, loop
from .runtime import nudged_case

NZ, PTOP = 63, 300.0
DT_ATMOS = {48: 900.0, 192: 225.0}
# module-level callables of dycore.hydro labelled in the traced dts
STAGES = (
    "_c_sw_half_3d", "_substep_core", "remap_step", "fv_tp_2d",
    "scalar_filter", "div_damp", "vort_damp", "corner_div_damp",
    "sim1_solve", "column_pressures", "halo_exchange",
    "halo_exchange_dgrid", "average_dgrid_boundary", "padded_cgrid_winds",
    "remap_levels", "fv_tp_2d_multi5",
)


def _labelled(name, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function(f"stage::{name}"):
            return fn(*args, **kwargs)

    return wrapper


def _us(event):
    """Duration of a profiler event in microseconds."""
    return event.time_range.elapsed_us()


def _dycore_steps(N, fused):
    """(step, traced step) of the dycore benchmark configuration."""
    advection.set_fused_transport(fused)
    run, _, _ = hydro.make_dycore_stepper(
        CubedSphereGrid.make(N, halo=3), NZ, DT_ATMOS[N], k_split=1,
        n_split=6, hord=5, kord=9, ptop=PTOP, dtype=torch.float32,
        device="cuda",
    )
    state = [hydro.benchmark_state(N, NZ, PTOP, "cuda")]
    phis = torch.zeros((6, N, N), device="cuda")

    def step():
        state[0] = run(state[0], phis, 1)

    return step, step


def _coupled_steps(N, out):
    """(step, traced step) of the coupled configuration: the fused step
    through CompiledTimeLoop, and its three stages in turn, labelled."""
    dense = coupled_bench.train_dense_artifact(
        os.path.join(out, f"dense_c{N}"), NZ, "cuda")
    wm, model = coupled_bench.initialize(N, "cuda", dense)
    loop = compiled_loop.CompiledTimeLoop(wm, ml_model=model)
    mdl = loop.mdl
    _, stages = compiled_loop.build_compiled_step(mdl, model, split=True)
    dyn, phys, post = (
        _labelled(f"coupled_{k}", stages[k])
        for k in ("dynamics", "physics", "postphysics")
    )

    def traced_step():
        cosz, solcon = loop._astronomy()
        st, _ = dyn(mdl.state, mdl.phis)
        st, tp, _, _ = phys(st, loop._tsfc, loop._on_device(mdl.total_precip),
                            cosz, solcon)
        mdl.state, _ = post(st)
        mdl.total_precip = tp

    return loop.step, traced_step


def _prognostic_steps(N, nudged_root=None):
    """(step, traced step) of the eager prognostic run: one TimeLoop step
    of the default model (hydrostatic, simple suite, f32) at C<N> x 63,
    or with `nudged_root` of the nudged run written there, its substeps
    labelled."""
    nudger = None
    if nudged_root is None:
        wrapper.initialize(wrapper.ModelConfig(npx=N + 1, npz=NZ),
                           device="cuda")
    else:  # warm-up, 5 timed and 2 traced steps: 2 h at 900 s
        _, nudger = nudged_case.initialize(N, "cuda", nudged_root,
                                           window_hours=3.0)
    tl = loop.TimeLoop(
        wrapper, derived_state.DerivedModelState(wrapper),
        wrapper.get_model().config.dt_atmos, postphysics_stepper=nudger,
    )
    for name in ("_compute_column_integrated_tracers", "_step_dynamics",
                 "_step_prephysics", "_step_physics", "_step_postphysics"):
        setattr(tl, name, _labelled(
            f"{'prognostic' if nudger is None else 'nudged'}{name}",
            getattr(tl, name)))
    steps = iter(tl)

    def step():
        next(steps)

    return step, step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=48, choices=sorted(DT_ATMOS))
    ap.add_argument("--fused", action="store_true",
                    help="fused 5-field transport on")
    ap.add_argument("--coupled", action="store_true",
                    help="the coupled step of bench.py rung 3 (C48)")
    ap.add_argument("--prognostic", action="store_true",
                    help="one step of the eager prognostic run (C48)")
    ap.add_argument("--nudged", action="store_true",
                    help="one step of the nudged run (C48)")
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args(argv)
    N = args.n
    if not torch.cuda.is_available():
        raise RuntimeError("step_profile needs a CUDA device")
    if args.coupled and (N != 48 or args.fused):
        raise ValueError("--coupled runs bench.py rung 3: C48, unfused")
    if args.prognostic and (N != 48 or args.fused or args.coupled):
        raise ValueError("--prognostic runs the default model: C48, "
                         "hydrostatic, unfused")
    if args.nudged and (N != 48 or args.fused or args.coupled
                        or args.prognostic):
        raise ValueError("--nudged runs the nudged case: C48, unfused")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    # the nudged case's restart files (~0.1 GB at C48) go to a temporary
    # directory, not to --out
    case = tempfile.TemporaryDirectory() if args.nudged else None
    step, traced_step = (
        _coupled_steps(N, args.out) if args.coupled
        else _prognostic_steps(N) if args.prognostic
        else _prognostic_steps(N, case.name) if args.nudged
        else _dycore_steps(N, args.fused)
    )
    step()  # warm-up
    torch.cuda.synchronize()

    host_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)

    originals = {name: getattr(hydro, name) for name in STAGES}
    traced_dts = 2
    try:
        for name, fn in originals.items():
            setattr(hydro, name, _labelled(name, fn))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(traced_dts):
                traced_step()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3 / traced_dts
    finally:
        for name, fn in originals.items():
            setattr(hydro, name, fn)

    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # device activity: kernels and copies, not the GPU-side spans of the
    # stage labels (those are reported separately as stage spans)
    kernels = [
        e for e in events
        if e.device_type == cuda and not e.name.startswith("stage::")
    ]
    busy_ms = sum(_us(e) for e in kernels) / 1e3 / traced_dts
    by_kernel = {}
    for e in kernels:
        k = by_kernel.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += _us(e) / 1e3 / traced_dts
    stages = {}  # name -> [calls, host ms, device span ms] per dt
    for e in events:
        if e.name.startswith("stage::"):
            s = stages.setdefault(e.name[7:], [0, 0.0, 0.0])
            if e.device_type == cuda:
                s[2] += _us(e) / 1e3 / traced_dts
            else:
                s[0] += 1
                s[1] += _us(e) / 1e3 / traced_dts
    host_med = sorted(host_ms)[len(host_ms) // 2]
    # autograd's scatter-add transposes (index_put_ with accumulate)
    scatter = [(c, ms) for k, (c, ms) in by_kernel.items()
               if "indexing_backward" in k]
    # copies: torch's copy kernels (.contiguous(), clone, copy_) and
    # memcpy activities
    copies = [(c, ms) for k, (c, ms) in by_kernel.items()
              if "copy" in k.lower()]
    summary = {
        "config": f"C{N}x{NZ} dt_atmos={DT_ATMOS[N]} k_split=1 n_split=6 "
                  f"hord=5 kord=9 f32 fused_transport={args.fused}"
                  + (" coupled (bench.py rung 3)" if args.coupled else "")
                  + (" prognostic (eager TimeLoop, hydrostatic, simple "
                     "suite)" if args.prognostic else "")
                  + (" nudged (eager TimeLoop from restarts, "
                     "nonhydrostatic, GFS suite, GFDL microphysics, six "
                     "tracers, nudger)" if args.nudged else ""),
        "card": card,
        "host_ms_per_dt": host_ms,
        "host_ms_per_dt_median": host_med,
        "traced_ms_per_dt": traced_ms,
        "device_busy_ms_per_dt": busy_ms,
        # idle share against the untraced step (the profiler slows the
        # host, not the kernels), and against the traced one
        "device_idle_share": 1.0 - busy_ms / host_med,
        "device_idle_share_traced": 1.0 - busy_ms / traced_ms,
        # kernels plus memcpy/memset activities
        "device_ops_per_dt": len(kernels) / traced_dts,
        "indexing_backward_calls_per_dt":
            sum(c for c, _ in scatter) / traced_dts,
        "indexing_backward_ms_per_dt": sum(ms for _, ms in scatter),
        "copy_ops_per_dt": sum(c for c, _ in copies) / traced_dts,
        "copy_ms_per_dt": sum(ms for _, ms in copies),
        "top_kernels_ms_per_dt": sorted(
            ([k[:120], c / traced_dts, ms]
             for k, (c, ms) in by_kernel.items()),
            key=lambda r: -r[2],
        )[:25],
        # per stage: calls, host ms (inclusive, traced) and the span
        # from its first to its last kernel on the device, per dt
        "stages_per_dt": sorted(
            ([k, c / traced_dts, host, span]
             for k, (c, host, span) in stages.items()),
            key=lambda r: -r[2],
        ),
    }
    os.makedirs(args.out, exist_ok=True)
    stem = os.path.join(
        args.out, f"step_profile_c{N}"
        + ("_fused" if args.fused else "_coupled" if args.coupled
           else "_prognostic" if args.prognostic
           else "_nudged" if args.nudged else "")
    )
    with open(stem + ".json", "w") as f:
        json.dump(summary, f, indent=1)
    with open(stem + ".txt", "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60
        ))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
