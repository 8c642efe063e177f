"""Where the time of one C48 (or C192) x 63 dycore dt, of one coupled
C48 step, or of one step of the prognostic run or of the nudged run at
C48, goes on the GPU.

Run on the GPU machine from the repository root:

    python -m fv3net_tpu_torch.step_profile [--n 48|192] [--fused]
                                            [--coupled | --prognostic
                                             | --nudged] [--out DIR]
    python -m fv3net_tpu_torch.step_profile --sw [--n 48|192|384]

Builds the benchmark configuration (bench.py ``_build_config``: C<n> x 63,
k_split=1, n_split=6, hord=5, kord=9, f32; dt_atmos 900 s at C48 and
225 s at C192, bench.py's rung 2), with the fused 5-field transport
(``ops.advection.set_fused_transport``) on if --fused; or with --coupled
the coupled step of bench.py rung 3 (``runtime.coupled_bench``: the
dycore + radiation + GFS physics + dense ML corrector, C48 only); or
with --prognostic one
step of the eager TimeLoop over the wrapper's phases (the default model:
hydrostatic C48 x 63, simple suite, f32, from the wrapper's initial
state; C48 only, its substeps labelled); or with --nudged one step of the
nudged run (``runtime.nudged_case``: the wrapper initialised from restart
files of a seeded moist state, nonhydrostatic, GFS suite with GFDL
microphysics over six advected species, the nudger of T and humidity
toward two snapshots; C48 only, its substeps labelled); or with --sw one
step of the shallow-water model (``dycore.make_sw_stepper`` at C<n>, dt
600 * 24 / n s, hord 5, d2 0.12, f32, a 3000 m layer with smooth 5 m/s
winds; its operators labelled).  The dycore dt and the coupled step are
what a user runs on the card: replays of their CUDA graphs
(``make_dycore_stepper``'s ``run``, ``CompiledTimeLoop.step``; the
warm-up dt captures them), as are the dycore and the units the JAX
package jits inside the prognostic and nudged steps (the physics, the
radiation, the ML predictors' apply: ``graphs.jit``).  With --eager the
dycore dt is ``run.one_dt`` and the coupled step
``build_compiled_step``'s eager stages, its three stages and the
dycore's functions labelled; the prognostic and nudged steps run every
unit and the dycore eagerly (``graphs.eager()``).  Warms up one dt,
then:
  * times 5 dts (30 steps of the prognostic and nudged runs, whose
    eager steps spread widely) with the host clock (synchronized), the
    step time a user sees;
  * traces 2 dts with torch.profiler (CPU + CUDA activities) and reports
    the device-busy time per dt (sum of kernel times), hence the device
    idle share, the number of kernel launches per dt, the copies per dt
    (torch's copy kernels and memcpy activities), the kernels by device
    time, and the host time of the labelled stages (each wrapped in a
    record_function label for the traced dts only).
Writes ``step_profile_c<n>[_fused|_coupled|_prognostic|_nudged|_sw]``
``[_eager].json`` and
``.txt`` under
--out and prints the JSON summary.

    python -m fv3net_tpu_torch.step_profile --train [--eager] [--out DIR]

profiles the dense training loop of ``chip_smoke.py`` phase 14 at the
train CLI's defaults (``DenseHyperparameters``: depth 3, width 64, 20
epochs of batches of 512) on seeded data of that phase's shape (4
batches of C48 x 63 columns, T and q in, dQ1 and dQ2 out): whole
trainings eager (``graphs.eager()``) and replayed (each step one
replayed CUDA graph, ``fit._shared.training_step``) in turns, the loop timed
between one pair of synchronisations (ms a step, samples/s); then one
epoch of the replayed loop (with --eager the eager one) traced after its
warm-up steps and capture: device busy ms a step and the idle share
against the untraced loop.  Writes ``step_profile_c48_train[_eager]``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import graphs, wrapper
from .dycore import hydro, sw
from .grid import CubedSphereGrid
from .ops import advection
from .runtime import compiled_loop, coupled_bench, derived_state, loop
from .runtime import nudged_case

NZ, PTOP = 63, 300.0
DT_ATMOS = {48: 900.0, 192: 225.0}
# module-level callables of dycore.hydro labelled in the eager dts
STAGES = (
    "_c_sw_half_3d", "_substep_core", "remap_step", "fv_tp_2d",
    "scalar_filter", "div_damp", "vort_damp", "corner_div_damp",
    "sim1_solve", "column_pressures", "halo_exchange",
    "halo_exchange_dgrid", "average_dgrid_boundary", "padded_cgrid_winds",
    "remap_levels", "fv_tp_2d_multi5",
)
# ... and of dycore.sw in the shallow-water step's traced steps
SW_STAGES = (
    "_c_sw_half_2d", "_sw_core", "fv_tp_2d", "scalar_filter", "div_damp",
    "vort_damp", "corner_div_damp", "halo_exchange", "halo_exchange_dgrid",
    "average_dgrid_boundary", "padded_cgrid_winds",
)
SW_SIZES = (48, 192, 384)
# steps timed with the host clock: the loop steps take more, their eager
# form spreading 15-75% between steps
TIMED = 5
TIMED_LOOP = 30


def _labelled(name, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function(f"stage::{name}"):
            return fn(*args, **kwargs)

    return wrapper


def _us(event):
    """Duration of a profiler event in microseconds."""
    return event.time_range.elapsed_us()


def _dycore_steps(N, fused, eager):
    """(step, traced step) of the dycore benchmark configuration: the
    replayed ``run``, or with `eager` the eager ``run.one_dt``."""
    advection.set_fused_transport(fused)
    run, _, _ = hydro.make_dycore_stepper(
        CubedSphereGrid.make(N, halo=3), NZ, DT_ATMOS[N], k_split=1,
        n_split=6, hord=5, kord=9, ptop=PTOP, dtype=torch.float32,
        device="cuda",
    )
    state = [hydro.benchmark_state(N, NZ, PTOP, "cuda")]
    phis = torch.zeros((6, N, N), device="cuda")

    def step():
        state[0] = run.one_dt(state[0], phis) if eager else run(
            state[0], phis, 1)

    return step, step


def _coupled_steps(N, out, eager):
    """(step, traced step) of the coupled configuration: the replayed
    step through CompiledTimeLoop, both; or with `eager` its eager step,
    and its three eager stages in turn, labelled."""
    dense = coupled_bench.train_dense_artifact(
        os.path.join(out, f"dense_c{N}"), NZ, "cuda")
    wm, model = coupled_bench.initialize(N, "cuda", dense)
    loop = compiled_loop.CompiledTimeLoop(wm, ml_model=model)
    if not eager:
        return loop.step, loop.step
    mdl = loop.mdl
    stages = compiled_loop.build_compiled_step(mdl, model).eager_stages

    def eager_step(dyn, phys, post):
        def step():
            cosz, solcon = loop._astronomy()
            st, _ = dyn(mdl.state, mdl.phis)
            st, tp, _, _ = phys(st, loop._tsfc,
                                loop._on_device(mdl.total_precip), cosz,
                                solcon)
            mdl.state, _ = post(st)
            mdl.total_precip = tp

        return step

    keys = ("dynamics", "physics", "postphysics")
    return eager_step(*(stages[k] for k in keys)), eager_step(*(
        _labelled(f"coupled_{k}", stages[k]) for k in keys))


def _sw_steps(N):
    """(step, traced step) of the shallow-water model through
    make_sw_stepper on the card: C<N>, a 3000 m deep layer with the smooth
    5 m/s winds of parity.smooth_wind."""
    from .parity import smooth_wind

    g = CubedSphereGrid.make(N, halo=3)
    run, _ = sw.make_sw_stepper(g, 600.0 * 24 / N, device="cuda")

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device="cuda")

    state = [sw.ShallowWaterState(
        t(np.full((6, N, N), 3000.0)),
        t(smooth_wind((6, 1, N + 1, N), 0.0)[:, 0]),
        t(smooth_wind((6, 1, N, N + 1), 1.0)[:, 0]),
    )]

    def step():
        state[0] = run(state[0], 1)

    return step, step


def _prognostic_steps(N, nudged_root=None, eager=False):
    """(step, traced step) of the prognostic run: one TimeLoop step of
    the default model (hydrostatic, simple suite, f32) at C<N> x 63, or
    with `nudged_root` of the nudged run written there, its substeps
    labelled; its dycore and units replayed, or with `eager` all
    eager."""
    nudger = None
    if nudged_root is None:
        wrapper.initialize(wrapper.ModelConfig(npx=N + 1, npz=NZ),
                           device="cuda")
    else:  # the warm-up, timed and traced steps inside the snapshots
        steps = 1 + TIMED_LOOP + 2
        _, nudger = nudged_case.initialize(
            N, "cuda", nudged_root, window_hours=steps * 900.0 / 3600 + 1)
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
        if eager:
            with graphs.eager():
                next(steps)
        else:
            next(steps)

    return step, step


# the training path: the dense loop of chip_smoke phase 14 at the train
# CLI's defaults, on seeded data of that phase's shape (4 batches of
# C48 x 63 columns, T and q in, dQ1 and dQ2 out)
TRAIN_BATCHES = 4
TRAIN_AB = ("eager", "replay", "replay", "eager")  # whole trainings, in turns
# steps before the trace: the eager warm-up steps and the capture
TRAIN_WARM = graphs.WARMUP + 1


def _train_batches(N, seed=0):
    from .util.quantity import Quantity

    rng = np.random.RandomState(seed)
    dims = ("tile", "z", "y", "x")
    return [{k: Quantity(rng.standard_normal((6, NZ, N, N)).astype(
        np.float32), dims)
        for k in ("air_temperature", "specific_humidity", "dQ1", "dQ2")}
        for _ in range(TRAIN_BATCHES)]


def _train_profile(N, eager, traced_epochs=1):
    """The dense training loop at DenseHyperparameters' defaults (depth 3,
    width 64, 20 epochs of batches of 512) on seeded data of phase 14's
    shape: whole trainings eager and replayed in turns (TRAIN_AB; the
    loop, ``fit._shared.run_steps``, timed between one pair of
    synchronisations: ms a step), then `traced_epochs` epochs of the
    replayed loop, or with `eager` the eager one, traced after its first
    TRAIN_WARM steps.  Returns (the runs' ms a step by side, the steps of
    a training, samples of a training, the profiler, the traced steps and
    their ms a step)."""
    from . import fit
    from .fit import _shared

    batches = _train_batches(N)
    hp = fit.DenseHyperparameters()
    real = _shared.run_steps
    loops = []

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = real(*args)
        torch.cuda.synchronize()
        loops.append(((time.perf_counter() - t0) * 1e3, len(losses)))
        return losses

    def train(epochs):
        return fit.train_dense_model(
            dataclasses.replace(hp, epochs=epochs), batches,
            input_variables=["air_temperature", "specific_humidity"],
            output_variables=["dQ1", "dQ2"], device="cuda")

    ms = {"eager": [], "replay": []}
    _shared.run_steps = timed
    try:
        for side in TRAIN_AB:
            with (graphs.eager() if side == "eager"
                  else contextlib.nullcontext()):
                train(hp.epochs)
            total, steps = loops.pop()
            ms[side].append(total / steps)
    finally:
        _shared.run_steps = real
    traced = {}

    def traced_loop(module, optimizer, loss_fn, batches):
        step = _shared.training_step(module, optimizer, loss_fn)
        batches = iter(batches)
        losses = [step(b) for _, b in zip(range(TRAIN_WARM), batches)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rest = [step(b) for b in batches]
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        traced.update(prof=prof, steps=len(rest), ms=traced_ms / len(rest))
        return losses + rest

    _shared.run_steps = traced_loop
    try:
        with graphs.eager() if eager else contextlib.nullcontext():
            train(traced_epochs)
    finally:
        _shared.run_steps = real
    nsamp = TRAIN_BATCHES * 6 * N * N
    return (ms, hp.epochs * -(-nsamp // hp.batch_size), hp.epochs * nsamp,
            traced["prof"], traced["steps"], traced["ms"])


def _write(stem, summary, prof):
    with open(stem + ".json", "w") as f:
        json.dump(summary, f, indent=1)
    with open(stem + ".txt", "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=60
        ))
    print(json.dumps(summary))


def _kernels(prof, steps):
    """(device busy ms, device ops, {kernel: [calls, ms]}) a step of the
    traced steps: kernels and copies, not the device spans of labels (the
    stage labels, the optimizer's ``Optimizer.step#...``)."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.events()
               if e.device_type == cuda and not e.name.startswith("stage::")
               and not getattr(e, "is_user_annotation", False)]
    by_kernel = {}
    for e in kernels:
        k = by_kernel.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += _us(e) / 1e3 / steps
    return (sum(_us(e) for e in kernels) / 1e3 / steps,
            len(kernels) / steps, by_kernel)


def main_train(N, eager, out, card):
    """--train: the summary of _train_profile, written to
    step_profile_c<N>_train[_eager].{json,txt} under `out`."""
    ms, steps, samples, prof, n_traced, traced_ms = _train_profile(N, eager)
    busy, ops, by_kernel = _kernels(prof, n_traced)
    side = "eager" if eager else "replay"
    med = {k: statistics.median(v) for k, v in ms.items()}
    summary = {
        "config": (f"dense training loop (DenseHyperparameters: depth 3, "
                   f"width 64, {steps} steps of 512 a training), "
                   f"{TRAIN_BATCHES} batches of C{N}x{NZ} columns, 126 "
                   f"features each way; traced: the "
                   f"{'eager' if eager else 'replayed'} loop"),
        "card": card,
        "ms_per_step": ms,
        "ms_per_step_median": med,
        "samples_per_s": {k: samples / (v * steps / 1e3)
                          for k, v in med.items()},
        "traced_steps": n_traced,
        "traced_ms_per_step": traced_ms,
        "device_busy_ms_per_step": busy,
        # against the untraced loop of the traced side, and the traced one
        "device_idle_share": 1.0 - busy / med[side],
        "device_idle_share_traced": 1.0 - busy / traced_ms,
        "device_ops_per_step": ops,
        "top_kernels_ms_per_step": sorted(
            ([k[:120], c / n_traced, t] for k, (c, t) in by_kernel.items()),
            key=lambda r: -r[2],
        )[:25],
    }
    os.makedirs(out, exist_ok=True)
    _write(os.path.join(out, f"step_profile_c{N}_train"
                        + ("_eager" if eager else "")), summary, prof)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=48, choices=SW_SIZES)
    ap.add_argument("--fused", action="store_true",
                    help="fused 5-field transport on")
    ap.add_argument("--coupled", action="store_true",
                    help="the coupled step of bench.py rung 3 (C48)")
    ap.add_argument("--prognostic", action="store_true",
                    help="one step of the eager prognostic run (C48)")
    ap.add_argument("--nudged", action="store_true",
                    help="one step of the nudged run (C48)")
    ap.add_argument("--sw", action="store_true",
                    help="one step of the shallow-water model")
    ap.add_argument("--train", action="store_true",
                    help="the dense training loop of chip_smoke phase 14 "
                         "at the train CLI's defaults (C48)")
    ap.add_argument("--eager", action="store_true",
                    help="the dycore dt or the coupled step eager, its "
                         "stages labelled; the prognostic or nudged step "
                         "with every unit eager")
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
    if args.sw and (args.fused or args.coupled or args.prognostic
                    or args.nudged):
        raise ValueError("--sw runs the shallow-water model alone")
    if args.train and (N != 48 or args.fused or args.coupled
                       or args.prognostic or args.nudged or args.sw):
        raise ValueError("--train runs the dense training loop alone (C48)")
    if args.eager and args.sw:
        raise ValueError("--eager profiles the dycore dt, the coupled, "
                         "prognostic or nudged step")
    if not args.sw and N not in DT_ATMOS:
        raise ValueError(f"the dycore step runs at C{sorted(DT_ATMOS)}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    if args.train:
        return main_train(N, args.eager, args.out, card)

    # the nudged case's restart files (~0.1 GB at C48) go to a temporary
    # directory, not to --out
    case = tempfile.TemporaryDirectory() if args.nudged else None
    step, traced_step = (
        _sw_steps(N) if args.sw
        else _coupled_steps(N, args.out, args.eager) if args.coupled
        else _prognostic_steps(N, eager=args.eager) if args.prognostic
        else _prognostic_steps(N, case.name, args.eager) if args.nudged
        else _dycore_steps(N, args.fused, args.eager)
    )
    step()  # warm-up
    torch.cuda.synchronize()

    host_ms = []
    for _ in range(TIMED_LOOP if args.prognostic or args.nudged else TIMED):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)

    module, names = ((sw, SW_STAGES) if args.sw
                     else (hydro, STAGES)
                     if args.eager and not (args.prognostic or args.nudged)
                     else (None, ()))
    originals = {name: getattr(module, name) for name in names}
    traced_dts = 2
    try:
        for name, fn in originals.items():
            setattr(module, name, _labelled(name, fn))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(traced_dts):
                traced_step()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3 / traced_dts
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)

    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # device activity: kernels and copies, not the GPU-side spans of the
    # stage labels (those are reported separately as stage spans)
    busy_ms, ops_per_dt, by_kernel = _kernels(prof, traced_dts)
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
        "config": (f"C{N} shallow water (Williamson 2) dt={600.0 * 24 / N} "
                   f"hord=5 d2=0.12 f32" if args.sw else
                   f"C{N}x{NZ} dt_atmos={DT_ATMOS[N]} k_split=1 n_split=6 "
                   f"hord=5 kord=9 f32 fused_transport={args.fused}")
                  + (" coupled (bench.py rung 3)" if args.coupled else "")
                  + (" prognostic (TimeLoop, hydrostatic, simple suite)"
                     if args.prognostic else "")
                  + (" nudged (TimeLoop from restarts, nonhydrostatic, "
                     "GFS suite, gray radiation, GFDL microphysics, six "
                     "tracers, nudger)" if args.nudged else "")
                  + (" eager" if args.eager else ""),
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
        "device_ops_per_dt": ops_per_dt,
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
        + ("_sw" if args.sw else "_fused" if args.fused
           else "_coupled" if args.coupled
           else "_prognostic" if args.prognostic
           else "_nudged" if args.nudged else "")
        + ("_eager" if args.eager else "")
    )
    _write(stem, summary, prof)


if __name__ == "__main__":
    main()
