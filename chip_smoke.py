"""Smoke check of the PyTorch/CUDA port (fv3net_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: require CUDA; print the card, its power limit, torch/CUDA;
  2. build: compile the eight kernels (csrc/*.cu) with nvcc, then the
     toolchain probe path (fv3net_tpu_torch.probe, K7 x*2+1 and K8 the
     3-point lane stencil on [256, 256]): launch counts; each kernel
     bit for bit equal to its plain version on [256, 256], [16384,
     16384] (PROBE_BIG), shapes whose columns are no multiple of 4 and
     views starting 1-3 floats past a 16-byte boundary; times at
     [256, 256] and [16384, 16384] (CUDA events, host, and the device
     time of the kernel and of torch.addcmul from a profiler trace);
  3. kernels: each dycore kernel against its plain torch version on the
     card, f32, nz = 63, seeded inputs, at the widths of C12, C48 and
     C192 (padded N = 18, 54, 198; the vertical solve and the remap on
     the interior n = 12, 48, 192, the remap in its cell-centred, u- and
     v-staggered shapes; each keyed by that width); max error and CUDA-event
     times (median of 20 calls) of each kernel's wrapper alone on
     pre-built inputs (K3 on q itself, beside the time of the two
     exchanges it no longer needs; K1 at hord 5, beside hord 1; K2 on the
     halo-padded pem, pm and ws the step passes it) and of
     its plain version, each beside its bound (BOUND_NOTE) and, for K7,
     beside one PyTorch call that computes the same function; the host
     time of each wrapper's Python call alone (host_ms); K6 also against
     five K1 calls; K1's single-layer form [6, N, N] (the shallow-water
     step's, areas [6, N, N]) in one launch against the [6, 1, N, N]
     form bit for bit and against the plain version; K3's exchanged-pair
     entry on the six faces' pair bit for bit against the table entry
     and on one face against its plain version; K1, K2, K4 and K5 at the
     shard shapes of phases 24-25 (one face [1, 63, ...] of C48, three
     faces' 24 x 24 tiles [3, 63, ...]) against their plain versions;
  4. slice parity: one dt at C12 x 63 f32 on CUDA (kernels) against the
     same dt on the CPU (plain torch) in f32 and float64, every state
     field (see F32_FACTOR), with the fused transport off and on;
  5. main path: the benchmark's C48 x 63 nonhydrostatic step
     (make_dycore_stepper, k_split=1, n_split=6, hord=5, kord=9, f32,
     fused transport off as the JAX package's default) on CUDA, where
     ``run`` replays a CUDA graph of one dt (fv3net_tpu_torch.graphs):
     two eager dts (``run.one_dt``) from one state, the replayed dt
     against them (bit for bit, or within their run-to-run spread,
     printed); per-dt kernel launch counts of the first replayed dt
     (the capture's warm-up is not counted) and of a later one; ms per dt
     of the eager loop and of the replay, AB_DTS_C48 of each in turns
     (CUDA events); one replay traced with torch.profiler, each kernel's
     device function counted by name (TRACE_NAMES) against the launch
     counts, the device busy time and the idle share of the replayed and
     of the eager dt; ms per dt over 5 replays, finite state, global
     dry-mass conservation, one dt against the CPU as in 4;
  6. C192 kernel path: the C192 x 63 step with the fused transport on
     (dt_atmos=225, bench.py rung 2), the configuration in which the JAX
     package runs its remap and fused-transport kernels, replayed as in
     5: the replayed dt against two eager dts, launch counts, eager and
     replayed ms (AB_DTS_C192 each, in turns), one replay traced (K6's
     two device functions a launch), ms per dt, finite state, dry mass,
     and one replayed dt against the same dt with the fused transport off,
     also replayed (another graph of the same stepper: the fused switch
     is part of the graph's key; see FUSED_BOUND).  A float64 CPU
     reference dt at C192 is out of reach (memory and hours of CPU), so
     this path is held to the unfused card dt, which phases 3-5 hold to
     the CPU.
 6b. C384 path: bench.py rung 4, C384 x 63 at dt_atmos 112.5 with the
     fused transport on, built with donate=True: the eager first dt
     (parked on the host), the first call (two eager warm-up dts, the
     capture, one replayed dt: launches counted, the peak of allocated
     memory), the returned state in the donated state's own buffers, the
     replayed dt against the eager one (bit for bit, or within the spread
     of a second eager dt, run only where they differ); C384_DTS
     replayed dts timed (CUDA events), one traced (each kernel's launches
     and device ms a dt, the idle share), finite state, dry mass; then
     the stepper built with donate=False, its first call's peak from the
     state reached.  There is no CPU reference at this size.
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
  9. coupled path: bench.py rung 3 at C48 x 63 (the dense model trained
     on the card as bench.py trains it, but on waves mapped onto physical
     sizes, so it is not bench.py's model: runtime.coupled_bench, dumped
     in the JAX package's format and read back through fit.load), the
     CompiledTimeLoop's step a replayed CUDA graph with the state
     donated: COUPLED_HELD_STEPS steps, each against two eager full_steps
     from the same state (state, total precipitation and every
     diagnostic, bit for bit or within the eager spread) with its kernel
     launches; step 0's diagnostics unchanged after the later steps; ms
     per full_step eager and replayed (AB_DTS_C48 each, in turns); ms per
     loop step and simulated years per day (CUDA events), ms per stage
     (dynamics, physics, postphysics; each stage its own graph), finite
     state, mass gates of each stage and the ML fill fractions.
 10. hydrostatic parity: one hydrostatic dt (no w, delz) at C12 x 63 f32
     with seeded phis on the card against the CPU in f32 and float64 by
     phase 4's rule, with its launch counts; and one eager wrapper step
     (step_dynamics ... apply_physics, fv3net_tpu_torch.parity) with the
     simple suite and with do_held_suarez=True and the "none" suite, on
     the card in f32 against the CPU in f32 and float64, from two seeded
     moist states: smooth winds and uncapped humidity by phase 4's rule;
     white-noise winds and humidity clipped flat at 20 g/kg by the f32
     spread (the CPU's f32 steps from 5 1-ulp perturbations of the
     inputs as well, see F32_FACTOR).
 10b. units: each unit the JAX package jits one by one on the serving
     paths, a ``graphs.jit`` on the card, at C48 x 63 f32 from a seeded
     moist state (parity.moist_inputs) with the GFS suite: the wrapper's
     Held-Suarez forcing, saturation adjustment, gscond and precpd,
     gfs_physics_step (Zhao-Carr; mass flux, gravity-wave drag and GFDL
     with the prognostic hydrometeors), the gray radiation's core, the
     steppers' humidity limiter and one jitted apply of each fit family
     (seeded weights, T and q in: dense apply and pure_fn, convolutional,
     graph, autoencoder and its encoder, CycleGAN both ways,
     precipitative, the FMR's rollout, the reservoir's step, the
     transformed family's heads): the first call (warm-up, capture,
     replay) and a second replay each against two eager calls
     (hold_replay), ms a call eager and replayed (UNIT_REPS each, in
     turns, CUDA events), the captures and the device memory they hold.
     The multiband driver's compute is held in phase 23.
 11. prognostic run: ``runtime.cli.main(["run-native", cfg, rundir])``
     on the card in a temporary directory, the default model (C48 x 63
     hydrostatic, simple suite, f32, dt_atmos 900, n_split 6) for
     PROGNOSTIC_STEPS steps with a water_vapor_path diagnostic every
     step, then ``append`` again from segment 0's RESTART: launches of
     K1-K6 in each step, ms per step (the whole iteration of append's
     loop: the TimeLoop step, the diagnostics sinks, the metrics and the
     scalar writes), per mainloop and per substep from the loop's Timer,
     each clock read after a synchronisation, finite state,
     dry mass across each step_dynamics, the restart round trip, the
     model time and the segments' files.  The steps take turns
     (SyncTimer, ``alternating``): even steps replay the captured dycore
     and units, odd steps run them eagerly (``graphs.eager()``), and the
     medians of each side are printed; steps PROGNOSTIC_TRACED of each
     segment (one of each side) run under torch.profiler: device busy
     ms and idle share.  Phases 13 (NUDGED_TRACED traced: its one
     replayed step after the capturing one stays untraced), 15, 16 and
     17 (SERIES_TRACED traced) take turns the same way.
 12. nudged parity: one eager step of the nudged run (a TimeLoop step
     with the nudger, runtime.nudged_case: the slice's configuration,
     nonhydrostatic, GFS suite with gray radiation and GFDL microphysics
     over six advected species, initialised from restart files that the
     port's write_restarts wrote from a seeded moist state, relative
     humidity up to 1.1, ice, rain and snow) at C12 x 63 on the card in
     f32 against the CPU in f32 and float64: every state field,
     total_precip and the nudging tendencies by phase 4's rule, the
     columns where a physics branch (phase 8's, and the GFDL scheme's
     freezing and melting) decided differently on the card than on the
     CPU in f32 counted, masked and bounded (NUDGED_FLIP_BOUND); then
     gfs_physics_step with the mass-flux convection, a seeded h_std
     (gravity-wave drag) and the GFDL microphysics with its hydrometeors
     on the same state, by the same rule (the mass flux's discrete
     choices masked too, SAS_CHOICE_RTOL).
 13. nudged run: the case at C48 x 63 (INPUT/ and two snapshots at T0
     and T0 + 1 h, the initial T + 3 K and humidity + 1e-4), the wrapper
     initialised from it on the card (its state equal to the CPU's ingest
     of the same files bit for bit), NUDGED_STEPS TimeLoop steps with
     the nudger: launches of K1-K6 in each step, ms per step (mainloop)
     and per substep (each clock read after a synchronisation), finite
     state, dry mass across each step_dynamics, the column water budget
     across each apply_physics (WATER_BOUND), the hydrometeors (no
     physics-made negatives, the negative mass the dycore's transport
     leaves within UNDERSHOOT_BOUND), GFDL precipitation, the nudging
     tendency of T; then state_after_timestep.zarr and
     nudging_tendencies.zarr written, open_nudge_to_fine (dQ1 equal to
     the stored tendency bit for bit) and batches_from_mapper (one batch
     a step); T, q, delp, the surface pressure, the total water path and
     the precipitation rate of each step written to diags/nudged.zarr
     (phase 20's verification).  The case's directory stays for phases
     14-20.
 14. training: the train CLI (fit.train.main, --device cuda) on phase
     13's stores (batches_from_mapper over open_nudge_to_fine: air
     temperature and specific humidity in, dQ1 and dQ2 out, 4 batches of
     13824 columns, 126 features each way) with a dense model at
     DenseHyperparameters' defaults (depth 3, width 64, 20 epochs of
     batches of 512): the loop of training steps (fit._shared.run_steps)
     timed between one pair of synchronisations, ms per step and samples
     per second over it (TrainClock), the mean loss of each epoch (the
     last below the first); one epoch with each step between
     synchronisations (its median, a per-layer statistic, StepClock,
     eager and replayed); AB_EPOCHS of the CLI's loop again eager
     (graphs.eager()) and replayed (fit._shared.training_step: each step
     one replayed CUDA graph, forward, backward and the Adam update) in
     turns (ab_training, AB_TRAINING): ms per step and samples/s of each
     side, the replayed run's parameters and every step's loss held
     against the eager runs' (hold_replay), the replayed steps' captures
     and the memory they hold; one
     Adam step and the first ten on the card against the CPU from the
     same init and batches, held by the f32 spread of the CPU's own run
     against runs from 1-ulp perturbations of the inputs
     (parity.f32_rule, HELD_STEPS): the parameters leaf by leaf and the
     predictions on a fixed batch (the last HOLD_ROWS samples); the same
     hold for the transformed family on phase 16's stored data (run in
     phase 16); the convolutional family on the same batches (one cube a
     step): ms per step, the loss, and the halo append's forward and
     backward alone, and its loop eager and replayed in turns.
 15. ML-corrected run: fit.load (no device: the card) of phase 14's
     model, the wrapper from the case's INPUT/ (nonhydrostatic, GFS with
     GFDL, six species), ML_STEPS TimeLoop steps with PureMLStepper:
     launches and ms a step, finite state, dry mass across step_dynamics,
     column water across apply_physics, the humidity limiter (no q + dQ2
     dt below 0 where dQ2 dries) and the first step's applied dQ1/dQ2
     against the CPU's float32 prediction by phase 4's rule (a float64
     prediction the reference); the run's diagnostics store
     (diags/ml.zarr, as phase 13's) and logs (diags/ml_logs: a scalar
     stream of the 2D fields' means and the loop's timing.json) for
     phase 20.
 16. emulated run: the case's INPUT/ again, with
     get_hooks(EmulationConfig(storage=...)) storing the gscond inputs
     and outputs (the Zhao-Carr path the hooks take) every step for
     STORED_STEPS steps; train_transformed (EMULATOR: the spec of
     tests/test_transformed_training.py at the family's default
     architecture, the cloud input without its log) on
     the card on the first three, held against the CPU as in 14, and
     AB_EPOCHS epochs of it eager and replayed in turns; the
     emulator (a DerivedModel giving its predictions the state's names,
     the cloud from the humidity change: emulation.gscond) dumped and, on
     the held-out step, its mean error against the no-change baseline;
     then get_hooks(EmulationConfig(gscond=ModelConfig(path))) drives
     EMULATED_STEPS steps: launches and ms a step, finite state, dry
     mass, column water, cloud water after each apply_physics >=
     CLOUD_BOUND.
 17. series: the case's INPUT/ again (GFS with GFDL, six species), no
     nudger and no ML, SERIES_STEPS TimeLoop steps: launches of K1-K6 in
     every step, ms per step and per substep, finite state, dry mass and
     column water as in 13; T, q, the surface temperature, the physics'
     precipitation rate and the cosine of the solar zenith angle of each
     step stored as phase 13 stores (series.zarr).  Phases 15-16 print
     the captures of the live units and the memory they hold.
 18. families: the train CLI (fit.train.main, no --device: the card) at
     C48x63 (T and q, 126 channels) and each family's default
     hyperparameters: the reservoir on the series (its last step held
     out; the scan's states against the float64 scan's by the CPU's f32
     spread, W_out by
     the ridge objective in float64 (OBJECTIVE_RATIO), the prediction
     after synchronize on the held-out step against the training steps'
     mean (RESERVOIR_SKILL), its error against persistence's printed;
     scan and ridge ms; the scan, one replayed graph a call, against
     two eager scans and timed both ways), the recurrent FMR on the
     series (cos zenith and the
     precipitation rate its forcings, FORCINGS), graph mpg and unet and the
     autoencoder on phase 13's stores, CycleGAN from the series' first
     steps (A) to the nudged run's (B): ms per training step and samples
     per second over the loops (TrainClock), the loss; each family's
     loop (its training function on the CLI's batches) eager and
     replayed in turns as in 14 (CycleGAN's generator and discriminator
     steps two graphs, replayed in eager's order); one Adam step and
     the first ten on the card against the CPU as phase 14 holds them
     (CycleGAN's generator and discriminator steps in pairs); each
     family's dump loaded with no device (the card) predicting what the
     trained model predicted (ROUND_TRIP_RTOL), and loaded in the CPU
     port predicting the same by the f32 spread.  The scikit-learn
     families (random forest, one-class SVM) are host code that needs
     scikit-learn, which the GPU machine lacks: they are not driven here
     (tests/test_torch_fit_sklearn.py holds them on the CPU).
 19. offline: ``diagnostics.cli offline`` (no --device: the card) on
     phase 14's dense model and on phase 18's graph (mpg) model, over
     open_nudge_to_fine of phase 13's stores, the Jacobian on: wall time
     and the column Jacobian's time apart, the files written; R^2, bias
     and RMSE per variable and domain and their per-level profiles
     against ``evaluate(device="cpu")`` by the f32 spread (the CPU's
     evaluations from 1-ulp perturbations of the inputs); the dense
     model's column Jacobian against the float64 network's, the CPU's
     f32 Jacobian setting the spread (the graph model predicts whole
     cubes: the evaluation has no column Jacobian for it, as the JAX
     package's); the predictions (predict_over_mapper) again, eager
     beside replayed (OFFLINE_AB each, in turns), and the captures of
     each model's apply with the memory they hold.
 20. prognostic-run diagnostics: ``diagnostics.cli compute`` (no
     --device: the card) of phase 15's ML-corrected run with phase 13's
     nudged run as --verification, at C48 x 63, against the same with
     --device cpu (diags.npz and metrics.json equal: the CLI's grid has no
     delp, so its groups are host numpy); ``metrics`` (the same metrics
     re-emitted) and ``report``; then compute_diagnostics with the run's
     delp in the grid (no device: the card), whose pressure-level groups
     interpolate on the card: against the CPU's float32 run by the f32
     rule of a float64 run, every other group and every metric equal;
     wall times of compute and report and the interpolation's apart (each
     call synchronised); ``log-viewer`` on phase 15's logs and
     ``single-run`` on phase 16's storage.  ``movies`` needs matplotlib
     (absent here) and ``shell`` is interactive: neither is driven.
 21. coarsening: a seeded C384 x 63 restart state on the card (float32,
     coarsening_state: restart_fields' recipe with terrain inside each
     coarse block, flat, moderate or rough, so ps varies by +-20-40 hPa
     inside a block and the blending weight is 1, strictly between or 0),
     coarsened to C48 x 63 by coarsen_restarts_on_sigma, _on_pressure and
     _via_blended_method, coarsen_sfc_data_complex on seeded surface
     data and compute_budget_ingredients with the default flux pairs:
     K5's launches (LAUNCHES_COARSENING), CUDA-event ms of each method;
     K5 against the plain remap (both boundary forms) on tile 0's first
     96 x 96 columns (phase 3's K5 tolerance), with target bottoms above
     and below the source's; column mass across K5 in the flat blocks
     (COARSE_MASS_BOUND); every output on 2 tiles x 6 x 6 coarse cells
     against the port's float64 run of the same fine columns on the CPU
     by the f32 spread (the CPU's float32 runs from the inputs and from
     5 1-ulp perturbations of them), the categorical surface fields
     equal.
 22. shallow water and the dycore's options: (a) Williamson 2 at C48
     (w2_fields, tests/test_sw.py's recipe) through make_sw_stepper on
     the card (c_sw scheme, hord 5, d2 0.12, f32) for SW_STEPS steps of
     300 s: K1 twice and K3 once a step, counted exactly, the state held
     against the CPU's float64 run by the f32 spread (the CPU's f32 runs
     from the state and from 1-ulp perturbations of it); the same with
     metric_cwinds=False and metric_ke=False; (b) Williamson 2 at C192
     for SW_C192_DAYS simulated day(s) at dt 75 s (the JAX test's five
     days with phase_sw_c192(days=5)): launches of every step,
     the area-weighted L2 height drift below 0.08 and max|u| below 150
     m/s (tests/test_sw.py's gates), total mass (float64 on the host) to
     MASS_BOUND, finite state; (c) ms per SW step at C192 and C384 (CUDA
     events, median of SW_TIMED after SW_WARMUP), and K1 and K3 on the
     arguments the step gives them, against their plain versions, timed
     beside the plain versions and the bound, with launches x (ms -
     bound) a step; (d) one C12 x 63 nonhydrostatic dt with c_half=False
     and one with forward-backward substeps (midpoint=False) on the card
     against the CPU by phase 4's rule, with their launch counts, and
     combined_wind_damping against the three dampers on the card at C48;
     (e) FregridLatLon (C48 -> 90 x 180) of a seeded [6, 63, 48, 48] f32
     field on the card against the CPU's float64 regrid by phase 4's
     rule, a constant field constant where dst_area > 0, and its times.
 23. radiation: MultibandRadiationDriver.gfs_radiation_driver on a
     seeded C48 x 63 state with land and snow (radiation_inputs) on the
     card in f32 against the CPU in f32 and float64 by phase 4's rule,
     every output; the SW and LW energy closure of the JAX package's
     tests (SW_CLOSURE, LW_CLOSURE) on the card's outputs and the
     float64 ones; the driver's jitted compute replayed against two
     eager calls (hold_replay); ms a call eager and replayed (CUDA
     events, RAD_REPS of each in turns), wall ms and the device's busy
     time (torch.profiler) of each, hence the host's share.
 24. spmd face: the multi-rank dycore (parallel/spmd_dycore.py) on the
     6-rank face mesh at C48 x 63 (the main path's configuration) on this
     card: 6 processes of one gloo group (multihost.spawn, each running
     ``chip_smoke.py --rank face DIR``; the kernel library built once
     here first), each holding one face on the card, exchanges staged
     through the host; 2 dts gathered and held against two single-process
     card dts (SPMD_SPREAD_FACTOR: bit for bit where those agree bit for
     bit) and the first against phase 5's CPU dts by phase 4's rule, dry
     mass; K1-K5's launches in every dt of every rank (K3 by its
     exchanged-pair entry); ms per dt (the slowest rank's CUDA events,
     median of SPMD_TIMED_DTS further dts) with the exchanges' host time,
     calls and bytes apart; then the same mesh in float64 on the CPU at
     C12 x 63 against the single-process float64 dt (SPMD_CPU_TOL).
 25. spmd tiled: the same on the (F, Y, X) = (2, 2, 2) mesh of 8 ranks
     (three faces' tiles each), 1 dt held: the tiled step takes the
     filter's and the vorticity damper's transpose forms (the JAX
     package's tiled path), so it is held by phase 4's rule against
     phase 5's CPU dts (its distance to the single-process card dt
     printed); K3 does not run there.
Each phase's wall seconds are printed ("phase NAME: S s").  On the card
every dycore ``run``, the coupled step and each unit of 10b replay CUDA
graphs: the wrappers' launch counters move by the launches each replay
makes.
Launch counts are read per path: K7/K8 on the probe path, K1-K5 on the
C48 main path, on the coupled C48 path and on the nudged, ML-corrected,
emulated and series paths, K6 on the C192 and C384 paths, K1, K3, K4 and K5 on the
prognostic path, K5 on the C384 -> C48 coarsening path, K1 and K3 on the
shallow-water path (a step at C48 and at C192, "sw"), K1-K5 in every rank
of the multi-rank paths ("spmd face C48", "spmd tiled C48": a rank's
launches a dt; K3's exchanged-pair entry, "del4_filter_pair", on the face
mesh).  Each kernel's JSON entry holds its launches (from the coupled C48
path for K1-K5, the C192 path for K6, the probe path for K7/K8, the spmd
face path for K3's pair entry; each path's in ``launches_by_path``) and
its phase-3 numbers at the shapes of the path its launches come from
(K1-K5 C48, K6 C192, K7/K8 [256, 256], the pair entry one face
[1, 63, 54, 54]); K7/K8's also their device ms and, under "at_16384",
their numbers at [16384, 16384].  The last two lines are the kernels'
JSON summary and {"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
import datetime
import functools
import json
import os
import re
import statistics
import subprocess
import tempfile
import time
import types

import numpy as np
import torch

from fv3net_tpu_torch import graphs, parity, probe, wrapper
from fv3net_tpu_torch.constants import GRAV
from fv3net_tpu_torch.dycore import riemann, sw
from fv3net_tpu_torch.dycore.hydro import (
    benchmark_state,
    hybrid_coefficients,
    make_dycore_stepper,
)
from fv3net_tpu_torch.emulation import gscond
from fv3net_tpu_torch.grid import CubedSphereGrid, halo_exchange
from fv3net_tpu_torch.grid import halo as halo_mod
from fv3net_tpu_torch.kernel_times import _halo_padded
from fv3net_tpu_torch.ops import _build, advection, cuda_column, remap
from fv3net_tpu_torch.ops.cuda_filter import (
    del4_filter_cuda,
    del4_filter_pair_cuda,
)
from fv3net_tpu_torch.ops.cuda_remap import ppm_remap_cuda
from fv3net_tpu_torch.ops.cuda_sim1 import sim1_solver_cuda
from fv3net_tpu_torch.ops.cuda_tp import fv_tp_2d_cuda, fv_tp_2d_multi5_cuda
from fv3net_tpu_torch.physics import gfdl_mp, gfs
from fv3net_tpu_torch.runtime import cli, compiled_loop, coupled_bench
from fv3net_tpu_torch.runtime import derived_state, nudged_case, segmented_run
from fv3net_tpu_torch.runtime import loop as loop_mod
from fv3net_tpu_torch.runtime import names, timing

H, NZ, DT_ATMOS, PTOP = 3, 63, 900.0, 300.0
DT_C192 = 225.0  # bench.py rung 2
DT_C384 = 112.5  # bench.py rung 4 (bench.py:417-431)
# each kernel wrapper's source and the TPU kernel it replaces, by the
# name the wrapper registered its launch counter under (ops._build.counted)
META = {
    "fv_tp_2d": ("fv3net_tpu_torch/csrc/tp2d.cu",
                 "fv3net_tpu/ops/pallas_tp.py:262"),
    "sim1_solver": ("fv3net_tpu_torch/csrc/sim1.cu",
                    "fv3net_tpu/ops/pallas_sim1.py:147"),
    "del4_filter": ("fv3net_tpu_torch/csrc/filter.cu",
                    "fv3net_tpu/ops/pallas_filter.py:60"),
    "del4_filter_pair": ("fv3net_tpu_torch/csrc/filter.cu",
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
if _build.COUNTED.keys() != META.keys():
    raise SystemExit(f"kernel wrappers {sorted(_build.COUNTED)} against "
                     f"the sources named here {sorted(META)}")
WRAPPERS = {k: _build.COUNTED[k] for k in META}
# launches per dt on the C48 main path (fused transport off): 5 transports
# x 6 substeps + 1 tracer, 1 vertical solve, 4 filters and 2 column chains
# per substep, and 6 remaps (pt, u, v, w, delz via sv, the tracer stack)
LAUNCHES_PER_DT = {
    "fv_tp_2d": 31, "sim1_solver": 6, "del4_filter": 24,
    "del4_filter_pair": 0,
    "column_pressures": 12, "ppm_remap": 6, "fv_tp_2d_multi5": 0,
    "probe_affine": 0, "probe_stencil": 0,
}
# ... on the C192 path (fused transport on): the five substep transports
# are one fused launch, K1 runs only for the tracer
LAUNCHES_PER_DT_FUSED = dict(LAUNCHES_PER_DT, fv_tp_2d=1, fv_tp_2d_multi5=6)
# kernels that run on the n x n interior (the others on the padded lattice)
INTERIOR = ("sim1_solver", "ppm_remap")
# each wrapper's device function, by the name a profiler trace gives it
# (csrc/*.cu); K6's call launches two (transport3, then transport2)
TRACE_NAMES = {
    "fv_tp_2d": "tp2d<", "sim1_solver": "sim1_kernel",
    "del4_filter": "del4<false>", "del4_filter_pair": "del4<true>",
    "column_pressures": "column_kernel", "ppm_remap": "remap_kernel",
    "fv_tp_2d_multi5": "transport3<", "probe_affine": "affine_kernel",
    "probe_stencil": "stencil_kernel",
}
# eager and replayed dts (and coupled steps) timed in turns at C48: the C48
# steps spread 15-75% between dts on a shared host (PERF.md section 2)
AB_DTS_C48 = 32
AB_DTS_C192 = 6  # device bound: 0.2-1.3% between dts
C384_DTS = 2  # timed replayed dts of the C384 path after the counted one
# (faces, interior width) of a rank of the multi-rank paths at C48: one
# face of the face mesh, three faces' 24 x 24 tiles of the (2, 2, 2) mesh
SHARD_SHAPES = ((1, 48), (3, 24))
# ... on the toolchain probe path: one call of each probe
LAUNCHES_PROBE = dict(
    {k: 0 for k in WRAPPERS}, probe_affine=1, probe_stencil=1
)
PROBES = (
    ("probe_affine", probe.affine_cuda, probe.affine_plain),
    ("probe_stencil", probe.stencil_cuda, probe.stencil_plain),
)
# the probes are also held at an HBM-bound size (1 GiB a tensor; each
# kernel moves 2 GiB, 0.641 ms at 3.35 TB/s) and on shapes whose columns
# are no multiple of 4 (the kernels' scalar paths and row wraps)
PROBE_BIG = (16384, 16384)
PROBE_ODD = ((1, 1), (2, 1), (1, 2), (3, 7), (4099, 4097))
# slice tolerance: u, v and w after one dt are small residuals of large
# cancelling terms, so one f32 dt differs from the float64 dt by ~1e-2 of
# their magnitude on ANY device (CPU f32 vs f64 at C12x63: u 3.0e-3, w
# 1.5e-2 relative).  The CUDA f32 step (kernels) must be as close to the
# float64 CPU step as the plain f32 CPU step is, per field (F32_FACTOR):
# max|cuda - f64| <= F32_FACTOR * max|cpu32 - f64| + 1e-7 * max|f64|
# (fv3net_tpu_torch.parity.f32_rule).  Where white-noise winds or
# humidity clipped flat at a cap put a limiter on a tie, a 1-ulp input
# change moves the CPU's own f32 step past that bound
# (tests/test_torch_f32_spread.py); such inputs are held by the f32
# spread: max|cpu32 - f64| taken over the CPU's f32 steps from the inputs
# and from parity.SPREAD_RUNS 1-ulp perturbations of them (phase 10)
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
COUPLED_HELD_STEPS = 3  # replayed coupled steps held against eager ones
# ... on the prognostic path (hydrostatic, two tracers): per dt three
# transports a substep (delp, pt, vorticity) and one a tracer, two
# filters a substep, one column chain a substep (the C-grid half-stage;
# the substep core keeps the plain chain, which gives the interface
# Exner function) and four remaps (pt, u, v, the tracer stack); no
# vertical solve or fused transport
LAUNCHES_PROGNOSTIC = dict(
    LAUNCHES_PER_DT, fv_tp_2d=20, sim1_solver=0, del4_filter=12,
    column_pressures=6, ppm_remap=4,
)
# ... and with one tracer (phase 10's hydrostatic dt)
LAUNCHES_HYDRO_1TR = dict(LAUNCHES_PROGNOSTIC, fv_tp_2d=19)
PROGNOSTIC_STEPS = 6  # steps of each segment of phase 11
PROGNOSTIC_TRACED = (4, 5)  # steps of each segment traced (replayed, eager)
# ... on the nudged path (nonhydrostatic, six tracers): the C48 main
# path's launches with five transports a substep and one a tracer
LAUNCHES_NUDGED = dict(LAUNCHES_PER_DT, fv_tp_2d=36)
NUDGED_STEPS = 4  # TimeLoop steps of phase 13, inside the snapshots' hour
NUDGED_TRACED = (3,)  # the step of phase 13 traced (eager; 2 is replayed)
# phase 13's column water budget across apply_physics: six species and
# the precipitation, less the surface evaporation, relative to the water
WATER_BOUND = 1e-5
# the dycore's tracer transport (hord 5, unlimited) is not positive
# definite: where a hydrometeor field ends at a sharp edge (ice only where
# T < 260 K) it undershoots zero (the JAX package's as well: the port's
# float64 step equals it, tests/test_torch_nudging.py, and phase 12 holds
# the card's hydrometeors to the CPU's).  The undershoot is a ripple of
# the transport: its negative mass is ~1e-3 of a species' positive mass
# or less (CPU, C12), where a fault of the transport (a sign, an index)
# would move O(1) of it; the bound tells the two apart.  The physics
# makes no field more negative than it found it.
UNDERSHOOT_BOUND = 0.1
# the mass-flux convection's discrete choices (launch level, cloud top):
# a column whose convective precipitation differs between the card and
# the CPU's f32 by more than this share took another choice (roundoff
# moves it by ~1e-6)
SAS_CHOICE_RTOL = 1e-3
# restart round trip: T is stored as computed from pt and converts back
# through the layer Exner function and (1 + zvir q): four f32 roundings
T_ULPS = 4
# exchange transposes against autograd's: each adjoint entry is a sum of
# up to 5 signed O(1) cotangents, added in another order
TRANSPOSE_RTOL, TRANSPOSE_ATOL = 1e-6, 1e-5
# coupled parity: at most this share of the columns may take another
# branch of a physics threshold in the card's f32 step than in the CPU's
FLIP_BOUND = 1e-3
# ... in the nudged run's C12 step (phase 12): the GFDL scheme adds two
# thresholds a level (freezing below T_ICE_ALL, melting above T_FREEZE),
# 126 a column, to phase 8's three a column.  With the card's and the
# CPU's f32 temperatures ~1e-4 K apart after a dt and ~2 K between
# levels, each column crosses one of them on one side only with a
# chance of ~1e-4 a threshold, ~0.1-1 of the 864 columns in all (one
# on an H100); 1% still fails a systematic disagreement
# (the bound of tests/test_torch_cuda.py's eager GFS step on the card)
NUDGED_FLIP_BOUND = 1e-2
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


def host_ms(fn, reps=20, warmup=3):
    """Median wall time in ms of the Python call fn() alone, without
    synchronising, while the card has queued work (a ~1 ms spin before
    each call), so the call never waits for the device: the wrapper's
    host share of a kernel's time."""
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


def record(stats, name, N, err, fn, plain, ins, outs, ops, library=None):
    """Time a kernel's wrapper alone (fn) on the card and on the host, its
    plain version and, where one PyTorch call computes the same function,
    that call; with the bound of the call, into stats[(name, N)]."""
    b_ms, b_by = bound(ins, outs, ops)
    stats[(name, N)] = dict(
        max_abs_err=err, ms=cuda_ms(fn), plain_ms=cuda_ms(plain),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=None if library is None else cuda_ms(library),
        host_ms=host_ms(fn),
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


def device_ms(fn, reps=20):
    """Device time of one call of fn() in ms: the summed durations of the
    device operations in a torch.profiler trace of `reps` calls (after
    one warm-up call) over `reps`, with their names; (None, []) where the
    trace holds no device operation."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda_t = torch.autograd.DeviceType.CUDA
    ops = [e for e in prof.events() if e.device_type == cuda_t]
    if not ops:
        return None, []
    us = sum(e.time_range.elapsed_us() for e in ops)
    return us / 1e3 / reps, sorted({e.name for e in ops})


def check_probe_shapes():
    """K7 and K8 bit for bit against their plain versions on shapes whose
    columns are no multiple of 4 and on contiguous views starting 1-3
    floats past a 16-byte boundary (the allocator's blocks start on one)."""
    rng = np.random.RandomState(1)
    cases = [((r, c), 0) for r, c in PROBE_ODD]
    cases += [(shape, off) for shape in ((3, 7), probe.SHAPE, (4099, 4097))
              for off in (1, 2, 3)]
    for (r, c), off in cases:
        buf = torch.as_tensor(rng.randn(r * c + off).astype(np.float32),
                              device="cuda")
        x = buf[off:].view(r, c)
        if x.data_ptr() % 16 != 4 * off:
            raise AssertionError(f"probe view [{r}, {c}] + {off}: "
                                 f"address {x.data_ptr()} off the plan")
        for name, fn, plain in PROBES:
            if not torch.equal(fn(x), plain(x)):
                raise AssertionError(
                    f"{name} [{r}, {c}] (+{off} floats): differs from its "
                    f"plain version")
    say(f"probes: bit for bit equal to plain on {len(cases)} shapes and "
        f"offsets {sorted(set(cases))}")


def phase_probe():
    """The toolchain probe path (K7, K8): one call of each through the
    probe's entry points, counted; each against its plain version bit for
    bit on the odd shapes and misaligned views, and at [256, 256] and
    PROBE_BIG, where each is timed (CUDA events, host, device time from a
    profiler trace) beside its plain version and, for K7, torch.addcmul."""
    x = torch.as_tensor(
        np.random.RandomState(0).randn(*probe.SHAPE).astype(np.float32),
        device="cuda",
    )
    reset_counts()
    ys = {"probe_affine": probe.affine(x), "probe_stencil": probe.stencil(x)}
    torch.cuda.synchronize()
    launches = read_counts()
    check_counts("probe", launches, LAUNCHES_PROBE)
    for name, _, plain in PROBES:
        if not torch.equal(ys[name], plain(x)):
            raise AssertionError(f"{name}: differs from its plain version")
    check_probe_shapes()
    stats = {}
    time_probes(stats, x)
    gen = torch.Generator(device="cuda").manual_seed(0)
    big = torch.randn(PROBE_BIG, device="cuda", generator=gen)
    time_probes(stats, big)
    del big
    torch.cuda.empty_cache()
    return launches, stats


def time_probes(stats, x):
    """K7 and K8 on x against their plain versions bit for bit, timed
    into stats[(name, rows)]; K7 beside torch.addcmul(1, x, 2), which
    computes x * 2 + 1 in one PyTorch call (no single call computes the
    periodic stencil)."""
    rows, cols = x.shape
    one, two = (torch.tensor(v, device="cuda") for v in (1.0, 2.0))
    library = {"probe_affine": lambda: torch.addcmul(one, x, two)}
    for name, fn, plain in PROBES:
        got, want = fn(x), plain(x)
        if not torch.equal(got, want):
            raise AssertionError(
                f"{name} [{rows}, {cols}]: differs from its plain version")
        err = float((got - want).abs().max())
        del got
        record(stats, name, rows, err, lambda: fn(x), lambda: plain(x),
               [x], [want], 2 * x.numel(), library=library.get(name))
        del want
        r = stats[(name, rows)]
        r["device_ms"], kernels = device_ms(lambda: fn(x))
        lib = library.get(name)
        r["library_device_ms"], lib_kernels = (
            (None, []) if lib is None else device_ms(lib))
        say(f"{name} [{rows}, {cols}]: bit for bit equal to plain; device "
            f"{r['device_ms']} ms {kernels}"
            + ("" if lib is None else
               f", torch.addcmul device {r['library_device_ms']} ms "
               f"{lib_kernels}"))


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
    # the single-layer (shallow-water) form [F, N, N], areas [F, N, N]:
    # one launch, the [F, 1, N, N] form's fluxes bit for bit and the plain
    # version's within K1's tolerance
    one = [a[k][:, 0].contiguous()
           for k in ("qx", "qy", "crx", "cry", "xfx", "yfx")]
    areas = [a[k][:, 0].contiguous() for k in ("apx", "apy")]
    launches = fv_tp_2d_cuda.launches
    got1 = advection.fv_tp_2d(*one, *areas, 5)
    if fv_tp_2d_cuda.launches != launches + 1:
        raise AssertionError(f"fv_tp_2d N={N} single layer: not one launch")
    got4 = fv_tp_2d_cuda(*(t[:, None] for t in one),
                         *(t[:, None] for t in areas), 5)
    want1 = advection.fv_tp_2d_plain(*one, *areas, 5)
    for name, g, g4, w in zip(("fx", "fy"), got1, got4, want1):
        if g.shape != (6, N, N) or not torch.equal(g, g4[:, 0]):
            raise AssertionError(f"fv_tp_2d N={N} single layer {name}: "
                                 f"not the [F, 1, N, N] form's fluxes")
        errs.append(check_close(f"fv_tp_2d N={N} single layer {name}", g,
                                w, 1e-4, 1e-3, sl[:1] + sl[2:]))
    say(f"fv_tp_2d N={N} single layer [6, {N}, {N}]: one launch, equal to "
        f"[6, 1, {N}, {N}] bit for bit, within K1's tolerance of plain")
    args, got = timed
    record(stats, "fv_tp_2d", N, max(errs), lambda: fv_tp_2d_cuda(*args),
           lambda: advection.fv_tp_2d_plain(*args), args[:8], got,
           OPS_TP2D_CELL * got[0].numel())
    # hord 1 has no edge arithmetic: the same copies and phases
    say(f"fv_tp_2d N={N}: hord 5 {stats[('fv_tp_2d', N)]['ms']:.4f} ms, "
        f"hord 1 {cuda_ms(lambda: fv_tp_2d_cuda(*args[:8], 1)):.4f} ms")


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
    """K2 fed as the step feeds it: dm, pt, dz, w [6, 63, n, n] and pem,
    pm, ws halo-padded (NaN in the halo), of which it reads the interior;
    against the plain version on the interior.  Keyed by n, the width it
    solves; its bound counts the interior bytes it must move."""
    args = _sim1_inputs(rng, n, dev)
    padded = args[:4] + [_halo_padded(torch, a) for a in args[4:]]
    dt = 150.0
    got = sim1_solver_cuda(dt, *padded, halo=H)
    want = riemann.sim1_solver(dt, *args)
    # tolerances of the JAX kernel test (test_pallas_kernels.py:151-162)
    errs = [
        check_close(f"sim1 n={n} w2", got[0], want[0], 1e-5, 1e-4),
        check_close(f"sim1 n={n} dz2", got[1], want[1], 1e-5, 1e-3),
        check_close(f"sim1 n={n} ppe", got[2], want[2], 1e-4,
                    float(want[2].abs().max()) * 1e-4),
    ]
    record(stats, "sim1_solver", n, max(errs),
           lambda: sim1_solver_cuda(dt, *padded, halo=H),
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
    launches = del4_filter_cuda.launches
    got = sw.scalar_filter(q, m, c)  # one launch, q read through tables
    if del4_filter_cuda.launches != launches + 1:
        raise AssertionError("scalar_filter: not one K3 launch")
    want = sw.scalar_filter_plain(q, m, c)
    # tolerance of the JAX kernel test (test_pallas_kernels.py:372)
    err = check_close(f"del4 n={n}", got, want, 1e-4, 1e-5)
    # the kernel reads q, the two gather tables and the padded areas
    tables = [halo_mod.scalar_gather_flat(n, H, NZ, fill, q.device)
              for fill in ("x", "y")]
    N = n + 2 * H
    record(stats, "del4_filter", N, err,
           lambda: del4_filter_cuda(q, m.area_px, m.area_py, c, H),
           lambda: sw.scalar_filter_plain(q, m, c),
           [q, *tables, m.area_px, m.area_py], [got],
           OPS_DEL4_CELL * got.numel())
    # the yardstick: the two exchanges the kernel used to be given
    ms_x = cuda_ms(lambda: (halo_exchange(q, H, fill="x"),
                            halo_exchange(q, H, fill="y")))
    ms = cuda_ms(lambda: sw.scalar_filter(q, m, c))
    say(f"del4 n={n}: scalar_filter {ms:.4f} ms (one launch); the x- and "
        f"y-fill exchanges it no longer makes {ms_x:.4f} ms")
    check_filter_pair(q, m, c, got, n, stats)


def check_filter_pair(q, m, c, table_out, n, stats):
    """K3's exchanged-pair entry (the face mesh's): on the six faces'
    exchanged pair it equals the table-reading entry bit for bit; on one
    face's pair [1, nz, N, N] (a face-mesh rank's shape) it agrees with
    the plain scalar_filter form of the whole cube on that face and with
    its own plain version (sw.scalar_filter_pair_plain), and is timed there."""
    qx = halo_exchange(q, H, fill="x").contiguous()
    qy = halo_exchange(q, H, fill="y").contiguous()
    got6 = del4_filter_pair_cuda(qx, qy, m.area_px, m.area_py, c, H)
    if not torch.equal(got6, table_out):
        d = float((got6 - table_out).abs().max())
        raise AssertionError(f"del4 pair n={n}: != table entry ({d:.3e})")
    f = 1
    args = (qx[f:f + 1].contiguous(), qy[f:f + 1].contiguous(),
            m.area_px[f:f + 1].contiguous(), m.area_py[f:f + 1].contiguous())
    got = del4_filter_pair_cuda(*args, c, H)
    check_close(f"del4 pair n={n} vs scalar_filter", got[0],
                sw.scalar_filter_plain(q, m, c)[f], 1e-4, 1e-5)
    err = check_close(f"del4 pair n={n}", got,
                      sw.scalar_filter_pair_plain(*args, c, H), 1e-4, 1e-5)
    record(stats, "del4_filter_pair", n + 2 * H, err,
           lambda: del4_filter_pair_cuda(*args, c, H),
           lambda: sw.scalar_filter_pair_plain(*args, c, H),
           list(args), [got], OPS_DEL4_CELL * got.numel())
    say(f"del4 pair n={n}: [6, ...] equals the table entry bit for bit; "
        f"[1, ...] max abs err {err:.3e}")


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
                record(stats, "ppm_remap", n, 0.0,
                       lambda: ppm_remap_cuda(*args),
                       lambda: remap.remap_levels_plain(*args),
                       args[:3], [got], ops)
        del q, pe1, pe2
        torch.cuda.empty_cache()
    stats[("ppm_remap", n)]["max_abs_err"] = max(errs)


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


def check_shards(rng, dev):
    """K1, K2, K4 and K5 at the shapes a rank of the multi-rank paths
    (phases 24-25) gives them (SHARD_SHAPES: F faces of interior width
    n), each against its plain version at the tolerance of its phase-3
    check: K1 at hord 5 in the area and mass forms, K2 on the halo-padded
    pem, pm and ws, K4, and K5 at kord 9, iv 1/0/-1, in its cell-centred
    and staggered shapes, with its column-mass gate."""
    for F, n in SHARD_SHAPES:
        N = n + 2 * H
        tag = f"shard F={F} n={n}"
        a = {k: v[:F].contiguous() for k, v in _tp_inputs(rng, N, dev).items()}
        sl = np.s_[:, :, 2 : N - 2, 2 : N - 2]
        for form in ("area", "mass"):
            apx, apy = a["apx"], a["apy"]
            if form == "mass":
                apx, apy = apx * a["dp"], apy * a["dp"]
            args = (a["qx"], a["qy"], a["crx"], a["cry"], a["xfx"],
                    a["yfx"], apx, apy, 5)
            got = fv_tp_2d_cuda(*args)
            want = advection.fv_tp_2d_plain(*args)
            for name, g, w in zip(("fx", "fy"), got, want):
                check_close(f"fv_tp_2d {tag} {form} {name}", g, w, 1e-4,
                            1e-3, sl)
        args = [x[:F].contiguous() for x in _sim1_inputs(rng, n, dev)]
        padded = args[:4] + [_halo_padded(torch, x) for x in args[4:]]
        got = sim1_solver_cuda(150.0, *padded, halo=H)
        want = riemann.sim1_solver(150.0, *args)
        check_close(f"sim1 {tag} w2", got[0], want[0], 1e-5, 1e-4)
        check_close(f"sim1 {tag} dz2", got[1], want[1], 1e-5, 1e-3)
        check_close(f"sim1 {tag} ppe", got[2], want[2], 1e-4,
                    float(want[2].abs().max()) * 1e-4)
        dp = torch.as_tensor(
            (900.0 + 200.0 * rng.rand(F, NZ, N, N)).astype(np.float32),
            device=dev,
        )
        got = cuda_column.column_pressures_cuda(dp, PTOP)
        want = cuda_column.column_pressures_plain(dp, PTOP)
        for name, g, w, rtol in zip(("pe", "pi", "pm"), got, want,
                                    (1e-6, 1e-5, 1e-5)):
            check_close(f"column {tag} {name}", g, w, rtol, 0.0)
        for stag in ((0, 0), (1, 0), (0, 1)):
            q, pe1, pe2 = [x[:F].contiguous()
                           for x in _remap_inputs(rng, n, stag, dev)]
            for iv in (1, 0, -1):
                rtag = f"remap {tag} stag={stag} iv={iv}"
                got = ppm_remap_cuda(q, pe1, pe2, iv, 9)
                want = remap.remap_levels_plain(q, pe1, pe2, iv, 9)
                check_close(rtag, got, want, 2e-5, 2e-5)
                rel, rel_plain = column_mass_error(q, pe1, pe2, got, want)
                if not rel <= 2e-4 + 2.0 * rel_plain:
                    raise AssertionError(f"{rtag}: column mass {rel:.3e}")
        say(f"{tag}: K1, K2, K4 and K5 at [{F}, {NZ}, ...] within their "
            f"plain versions' tolerances")


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
    check_shards(np.random.RandomState(1), "cuda")
    return stats


def report_kernels(stats):
    for (name, N), r in sorted(stats.items()):
        lib = r["library_ms"]
        say(f"kernel {name:17s} width={N:3d} "
            f"max_abs_err={r['max_abs_err']:.3e} kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.1%} of it) host "
            f"{r['host_ms']:.4f} ms library "
            + ("none" if lib is None else f"{lib:.4f} ms")
            + ("" if "device_ms" not in r else
               f" device {r['device_ms']} ms library device "
               f"{r['library_device_ms']} ms"))


# --- phases 4 and 5 ---------------------------------------------------------


def stepper(g, device, dtype=torch.float32, dt_atmos=DT_ATMOS, **flags):
    return make_dycore_stepper(
        g, NZ, dt_atmos, k_split=1, n_split=6, hord=5, kord=9,
        ptop=PTOP, dtype=dtype, device=device, **flags,
    )


def compare_states(tag, got, plain32, ref64, fields=None, perturbed=()):
    """Per field: the CUDA f32 state against the plain f32 CPU state and
    both against the float64 CPU state (see F32_FACTOR); with
    `perturbed` (the CPU's f32 steps from 1-ulp perturbations of the
    inputs) against the worst of the CPU's f32 steps.  States are
    NamedTuples or mappings of name -> tensor; `fields` defaults to
    those of ref64."""
    rule = parity.f32_rule(got, [plain32, *perturbed], ref64, fields)
    a_all, p_all = parity.as_fields(got), parity.as_fields(plain32)
    for k, (e_cuda, bound, scale, errs, finite) in rule.items():
        gap = float((a_all[k].double().cpu() - p_all[k].double().cpu())
                    .abs().max())
        spread = (f" max|perturbed-f64| {max(errs[1:]):.3e}"
                  if perturbed else "")
        say(f"{tag} {k:5s} max|f64| {scale:.3e} max|cuda-cpu32| "
            f"{gap:.3e} max|cuda-f64| {e_cuda:.3e} "
            f"max|cpu32-f64| {errs[0]:.3e}{spread}")
        if not finite or e_cuda > bound:
            raise AssertionError(f"{tag} {k}: {e_cuda:.3e} > {bound:.3e}")


def cpu_references(g, n):
    """One dt of the plain path on the CPU, in f32 and in float64, from
    the same f32 initial state (kept for the later phases that hold a dt
    of the same state: the multi-rank ones)."""
    if n in _CPU_REFS:
        return _CPU_REFS[n]
    _CPU_REFS[n] = _cpu_references(g, n)
    return _CPU_REFS[n]


def _cpu_references(g, n):
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
    """The C48 dt: two eager dts against each other, the replayed dt
    (the counted main path) against them, eager and replayed ms in turns,
    one replay traced, mass and the CPU references."""
    n = 48
    g = CubedSphereGrid.make(n, halo=H)
    run, m, _ = stepper(g, "cuda")
    state = benchmark_state(n, NZ, PTOP, "cuda")
    phis = torch.zeros((6, n, n), device="cuda")
    mass0 = dry_mass(state, m)
    eager = run.one_dt(state, phis)
    again = run.one_dt(state, phis)

    reset_counts()
    first = run(state, phis, 1)  # capture, then one replayed dt: counted
    torch.cuda.synchronize()
    launches = read_counts()
    check_counts("C48x63 one replayed dt", launches, LAUNCHES_PER_DT)
    hold_replay("C48x63", first, eager, again)
    reset_counts()
    run(first, phis, 1)
    torch.cuda.synchronize()
    check_counts("C48x63 a later replayed dt", read_counts(), LAUNCHES_PER_DT)
    med = ab_ms("C48x63 dt", lambda s: run.one_dt(s, phis),
                lambda s: run(s, phis, 1), first, AB_DTS_C48)
    busy, _ = trace_replay("C48x63", lambda: run(first, phis, 1),
                           LAUNCHES_PER_DT)
    say(f"C48x63 device busy {busy:.3f} ms a dt: idle share of the "
        f"replayed dt {1.0 - busy / med['replay']:.3f}, of the eager dt "
        f"{1.0 - busy / med['eager']:.3f}")
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


def fields_of(x):
    """name -> tensor of a DycoreState or of a mapping (None dropped)."""
    items = x._asdict().items() if hasattr(x, "_asdict") else x.items()
    return {k: v for k, v in items if v is not None}


def hold_replay(tag, got, eager, again):
    """The replayed result against the eager one, field by field: each
    element within |eager - again| of it, the spread of two eager runs
    from the same inputs (bit for bit where they agree)."""
    got, eager, again = (fields_of(x) for x in (got, eager, again))
    worst = {}
    for k, e in eager.items():
        diff = (got[k] - e).abs()
        spread = (e - again[k]).abs()
        bad = int((diff > spread).sum())
        worst[k] = (float(diff.max()), float(spread.max()))
        if bad or not bool(torch.isfinite(got[k]).all()):
            raise AssertionError(
                f"{tag} {k}: {bad} values of the replay outside the eager "
                f"spread (max|replay-eager| {worst[k][0]:.3e}, max "
                f"spread {worst[k][1]:.3e})")
    same = all(d == 0.0 for d, _ in worst.values())
    spread = max(sp for _, sp in worst.values())
    say(f"{tag} replay vs eager: bit for bit {same}; max|replay-eager| "
        f"{max(d for d, _ in worst.values()):.3e}, eager run-to-run spread "
        f"{spread:.3e} ({len(worst)} fields)")
    return same, spread


def ab_ms(tag, eager, replay, s0, n):
    """ms per call of `eager` and of `replay` (callables of the carried
    state), n of each in turns (A B B A ...) by CUDA events, each chain
    from s0; returns their medians."""
    times = {"eager": [], "replay": []}
    chains = {"eager": s0, "replay": s0}
    fns = {"eager": eager, "replay": replay}
    for i in range(n):
        for k in (("eager", "replay") if i % 2 == 0 else ("replay", "eager")):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            chains[k] = fns[k](chains[k])
            t1.record()
            torch.cuda.synchronize()
            times[k].append(t0.elapsed_time(t1))
    med = {k: statistics.median(v) for k, v in times.items()}
    say(f"{tag} ms eager {med['eager']:.3f} replay {med['replay']:.3f} "
        f"(medians of {n} each, in turns; eager "
        f"{[round(t, 3) for t in times['eager']]}; replay "
        f"{[round(t, 3) for t in times['replay']]})")
    return med


def trace_replay(tag, step, expected):
    """One replayed step under torch.profiler: each kernel's device
    launches, found by its device function's name (TRACE_NAMES), must be
    the wrappers' counts `expected`; returns (device busy ms, {kernel:
    (launches, device ms)})."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    cuda_t = torch.autograd.DeviceType.CUDA
    ops = [e for e in prof.events() if e.device_type == cuda_t]
    busy = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    seen = {}
    for k, pat in TRACE_NAMES.items():
        hits = [e for e in ops if pat in e.name]
        seen[k] = (len(hits),
                   sum(e.time_range.elapsed_us() for e in hits) / 1e3)
    second = sum(1 for e in ops if "transport2<" in e.name)
    say(f"{tag} trace of one replay: {len(ops)} device ops, busy "
        f"{busy:.3f} ms; kernels (launches, device ms) "
        f"{ {k: (c, round(ms, 4)) for k, (c, ms) in seen.items() if c} }")
    wrong = {k: (seen[k][0], c) for k, c in expected.items()
             if seen[k][0] != c}
    if wrong or second != expected["fv_tp_2d_multi5"]:
        raise AssertionError(
            f"{tag}: traced launches differ from the counts {wrong}, "
            f"transport2 {second}")
    return busy, seen


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
        eager = run.one_dt(state, phis)
        again = run.one_dt(state, phis)
        reset_counts()
        fused = run(state, phis, 1)  # capture, then the counted replay
        torch.cuda.synchronize()
        launches = read_counts()
        check_counts("C192x63 fused one replayed dt", launches,
                     LAUNCHES_PER_DT_FUSED)
        hold_replay("C192x63 fused", fused, eager, again)
        del eager, again
        ab_ms("C192x63 fused dt", lambda s: run.one_dt(s, phis),
              lambda s: run(s, phis, 1), fused, AB_DTS_C192)
        trace_replay("C192x63 fused", lambda: run(fused, phis, 1),
                     LAUNCHES_PER_DT_FUSED)
        s = timed_dts("C192x63 fused", run, fused, phis, n, steps=5)
    finally:
        advection.set_fused_transport(False)
    check_state("C192x63 fused", s, m, mass0, 6)
    del s
    # both replayed: the unfused dt is another graph of the same stepper
    unfused = run(state, phis, 1)
    again = run(state, phis, 1)
    for k in fused._fields:
        a, b, c = (getattr(x, k) for x in (fused, unfused, again))
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        say(f"C192x63 {k:5s} max|field| {scale:.3e} max|fused-unfused| "
            f"{err:.3e} max|unfused-unfused| {float((b - c).abs().max()):.3e}"
            f" (bound {FUSED_BOUND} x max|field|; both replayed)")
        if not bool(torch.isfinite(a).all()) or err > FUSED_BOUND * scale:
            raise AssertionError(f"C192x63 fused vs unfused {k}: {err:.3e}")
    return launches


def first_replay(tag, run, state, phis):
    """The first call of a C384 stepper (two eager warm-up dts, the
    capture, one replayed dt), counted; returns (state, launches, peak
    allocated bytes during the call)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    s = run(state, phis, 1)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    say(f"{tag}: first call (2 eager warm-up dts, capture, one replay) "
        f"{time.perf_counter() - t0:.1f} s; peak allocated {peak / 1e9:.3f} "
        f"GB ({base / 1e9:.3f} GB before the call: the state and the "
        f"metrics), reserved {torch.cuda.memory_reserved() / 1e9:.3f} GB")
    check_counts(f"{tag} one replayed dt", launches, LAUNCHES_PER_DT_FUSED)
    return s, launches, peak


def phase_c384_path():
    """bench.py rung 4: C384 x 63 at dt_atmos 112.5 with the state
    donated, on one card (module docstring, phase 6b)."""
    n = 384
    g = CubedSphereGrid.make(n, halo=H)
    phis = torch.zeros((6, n, n), device="cuda")
    advection.set_fused_transport(True)
    try:
        t0 = time.perf_counter()
        run, m, _ = stepper(g, "cuda", dt_atmos=DT_C384, donate=True)
        state = benchmark_state(n, NZ, PTOP, "cuda")
        say(f"C384x63: stepper and state built in "
            f"{time.perf_counter() - t0:.1f} s; one f32 field "
            f"{6 * NZ * n * n * 4 / 1e9:.3f} GB")
        mass0 = dry_mass(state, m)
        # the initial state and the eager first dt, parked on the host
        start = [x.cpu() for x in state]
        eager = {k: v.cpu() for k, v in fields_of(
            run.one_dt(state, phis)).items()}
        s, launches, peak = first_replay("C384x63 donate=True", run, state,
                                         phis)
        if [x.data_ptr() for x in s] != [x.data_ptr() for x in state]:
            raise AssertionError("C384x63: the donated state was copied")
        diff = {k: (v.cpu() - eager[k]).abs() for k, v in fields_of(s).items()}
        same = not any(bool(d.any()) for d in diff.values())
        spread = 0.0
        if not same:
            # a second eager dt from the initial state: the run-to-run
            # spread the replay is held to
            again = fields_of(run.one_dt(
                type(state)(*(x.cuda() for x in start)), phis))
            sp = {k: (v.cpu() - eager[k]).abs() for k, v in again.items()}
            bad = {k: int((d > sp[k]).sum()) for k, d in diff.items()}
            spread = max(float(v.max()) for v in sp.values())
            if any(bad.values()):
                raise AssertionError(f"C384x63 replay vs eager: {bad}")
        say(f"C384x63 first replayed dt vs the eager first dt: bit for bit "
            f"{same}; max|replay-eager| "
            f"{max(float(d.max()) for d in diff.values()):.3e}, eager "
            f"spread {spread:.3e}")
        del start, eager, diff
        times = []
        for _ in range(C384_DTS):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            s = run(s, phis, 1)
            t1.record()
            torch.cuda.synchronize()
            times.append(t0.elapsed_time(t1))
        ms = statistics.median(times)
        say(f"C384x63 fused ms/dt {ms:.3f} (replayed, donated; median of "
            f"{C384_DTS}: {[round(t, 3) for t in times]}) simulated "
            f"days/day {DT_C384 / (ms / 1e3):.2f}")
        busy, seen = trace_replay("C384x63 fused", lambda: run(s, phis, 1),
                                  LAUNCHES_PER_DT_FUSED)
        say(f"C384x63 idle share of the replayed dt {1.0 - busy / ms:.3f} "
            f"(busy from the traced replay); kernels' device ms a dt "
            f"{ {k: round(v[1], 3) for k, v in seen.items() if v[0]} }")
        check_state("C384x63 fused", s, m, mass0, C384_DTS + 2)
        # the same dt without donation, from the state reached: its
        # first call's peak (the donated graph freed first)
        del run, m, state
        torch.cuda.empty_cache()
        run, _, _ = stepper(g, "cuda", dt_atmos=DT_C384)
        _, _, peak_nd = first_replay("C384x63 donate=False", run, s, phis)
        del run, s
    finally:
        advection.set_fused_transport(False)
    torch.cuda.empty_cache()
    say(f"C384x63 peak allocated: donate=True {peak / 1e9:.3f} GB, "
        f"donate=False {peak_nd / 1e9:.3f} GB")
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


def hold_flipped(tag, got, plain32, ref64, detectors, flip_bound):
    """Count the columns that each detector (name -> [6, n, n] mask) finds
    flipped, bound their union (a share `flip_bound` of the columns), mask
    them, and hold the rest of each field by phase 4's rule
    (compare_states).  The states are mappings of name -> tensor."""
    flips = None
    for name, mask in detectors.items():
        flips = mask if flips is None else flips | mask
    nflip, ncol = int(flips.sum()), flips.numel()
    by = ", ".join(f"{k} {int(m.sum())}" for k, m in detectors.items())
    say(f"{tag}: {nflip} of {ncol} columns took another physics branch on "
        f"the card than on the CPU in f32 ({by}; bound {flip_bound})")
    if nflip > flip_bound * ncol:
        raise AssertionError(f"{tag}: {nflip} flipped columns")
    masked = [{} for _ in range(3)]
    for k in ref64:
        arrays = [x[k] for x in (got, plain32, ref64)]
        if not bool(torch.isfinite(arrays[0]).all()):
            raise AssertionError(f"{tag} {k}: not finite")
        keep = ~_column_mask(flips, arrays[0])
        for m, x in zip(masked, arrays):
            m[k] = torch.where(keep, x, 0.0)
    compare_states(tag, *masked)


def phase_coupled_parity():
    """One coupled C12 step on the card in f32 against the CPU in f32 and
    float64, from the same perturbed f32 state, all with the dense model
    trained once on the card (module docstring, 8)."""
    n = 12
    coupled_bench.train_dense_artifact(DENSE_DIR, NZ, "cuda")
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
    ref64, plain32, got = (
        dict(out[0]._asdict(), total_precip=out[1], diags=out[2])
        for out in (coupled_step(n, "cpu", "float64", st),
                    coupled_step(n, "cpu", "float32", st),
                    coupled_step(n, "cuda", "float32", st)))
    flips = flipped_columns(got.pop("diags"), plain32.pop("diags"))
    ref64.pop("diags")
    hold_flipped("C12x63 coupled", got, plain32, ref64, {"gfs": flips},
                 FLIP_BOUND)


def global_sum(x, area):
    """sum(x * area) over [6, nz, n, n] in float64."""
    return float((x.double() * area[:, None]).sum())


def phase_coupled_path():
    """bench.py rung 3 at C48 x 63 (module docstring, 9)."""
    n = 48
    coupled_bench.train_dense_artifact(DENSE_DIR, NZ, "cuda")
    wm, model = coupled_bench.initialize(n, "cuda", DENSE_DIR)
    mdl = wm.get_model()
    loop = compiled_loop.CompiledTimeLoop(wm, ml_model=model)
    area = torch.as_tensor(mdl.area, dtype=torch.float64, device="cuda")

    eager = loop._step_fn.eager

    def clone(st):
        return type(st)(*(None if x is None else x.clone() for x in st))

    kept = None
    for step in range(COUPLED_HELD_STEPS):
        # two eager full_steps from the loop's state, then the loop's
        # replayed step (the first captures; each counted)
        cosz, solcon = loop._astronomy()
        args = (mdl.phis, loop._tsfc, loop._on_device(mdl.total_precip),
                cosz, solcon)
        runs = [eager(clone(mdl.state), *args) for _ in range(2)]
        reset_counts()
        diags = loop.step()
        torch.cuda.synchronize()
        launches = read_counts()
        check_counts(f"C48x63 coupled replayed step {step}", launches,
                     LAUNCHES_COUPLED)
        got = dict(fields_of(mdl.state), total_precip=mdl.total_precip,
                   **{f"diag {k}": q.data for k, q in diags.items()})
        want = [dict(fields_of(r[0]), total_precip=r[1],
                     **{f"diag {k}": v for k, v in r[3].items()})
                for r in runs]
        hold_replay(f"C48x63 coupled step {step}", got, *want)
        del runs, want
        if kept is None:
            first = diags
            kept = {k: q.data.clone() for k, q in diags.items()}
    changed = [k for k, q in first.items() if not torch.equal(q.data, kept[k])]
    say(f"C48x63 coupled: step 0's {len(kept)} diagnostics after "
        f"{COUPLED_HELD_STEPS - 1} more steps unchanged: {not changed}")
    if changed:
        raise AssertionError(f"C48x63 coupled: step 0's {changed} changed")
    for k, q in diags.items():
        if k.endswith("_filled_frac") and float(q.data) != 0.0:
            raise AssertionError(f"C48x63 coupled: {k} = {float(q.data)}")
    cosz, solcon = loop._astronomy()
    args = (mdl.phis, loop._tsfc, loop._on_device(mdl.total_precip), cosz,
            solcon)
    # (the replayed chain runs in the step's donated buffers: the loop's)
    med = ab_ms("C48x63 coupled step (full_step)",
                lambda st: eager(st, *args)[0],
                lambda st: loop._step_fn(st, *args)[0], clone(mdl.state),
                AB_DTS_C48)
    busy, _ = trace_replay("C48x63 coupled",
                           lambda: loop._step_fn(mdl.state, *args),
                           LAUNCHES_COUPLED)
    say(f"C48x63 coupled device busy {busy:.3f} ms a step: idle share of "
        f"the replayed step {1.0 - busy / med['replay']:.3f}, of the eager "
        f"step {1.0 - busy / med['eager']:.3f}")
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
        f"{dt / (ms / 1e3) / 365.25:.4f} (the MLP trained on waves mapped "
        f"onto physical sizes, not bench.py's raw waves: "
        f"coupled_bench.PHYSICAL)")

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


# --- phases 10 and 11 -------------------------------------------------------


def phase_hydrostatic_parity():
    """One hydrostatic C12 dt on the card against the CPU (f32, f64), and
    one eager wrapper step of the simple and the Held-Suarez suites
    (module docstring, 10)."""
    n = 12
    g = CubedSphereGrid.make(n, halo=H)
    st = benchmark_state(n, NZ, PTOP, "cpu")._replace(w=None, delz=None)
    phis = 2000.0 * torch.as_tensor(
        np.abs(np.random.RandomState(4).randn(6, n, n)))
    out = []
    for device, dtype in (("cpu", torch.float64), ("cpu", torch.float32),
                          ("cuda", torch.float32)):
        run, _, _ = stepper(g, device, dtype)
        reset_counts()
        out.append(run(type(st)(*(None if x is None else
                                  x.to(device=device, dtype=dtype)
                                  for x in st)),
                       phis.to(device=device, dtype=dtype), 1))
    torch.cuda.synchronize()
    check_counts("C12x63 hydrostatic one dt", read_counts(),
                 LAUNCHES_HYDRO_1TR)
    ref64, plain32, got = out
    if got.w is not None or got.delz is not None:
        raise AssertionError("hydrostatic dt returned w or delz")
    compare_states("C12x63 hydrostatic", got, plain32, ref64,
                   fields=("delp", "pt", "u", "v", "q"))
    for kw in ({}, {"do_held_suarez": True, "physics_suite": "none"}):
        for noisy in (False, True):
            eager_parity(n, kw, noisy)


def eager_parity(n, config, noisy):
    """One eager wrapper step at C<n> x 63 from parity.moist_inputs on
    the card in f32 against the CPU in f32 and float64: smooth inputs by
    phase 4's rule, noisy ones (white-noise winds, humidity clipped flat)
    by the f32 spread of parity.SPREAD_RUNS 1-ulp perturbations
    (F32_FACTOR)."""
    inputs = parity.moist_inputs(n, NZ, noisy=noisy)
    ref64, plain32, got = (
        parity.wrapper_step(n, NZ, device, dtype, config, inputs)
        for device, dtype in (("cpu", "float64"), ("cpu", "float32"),
                              ("cuda", "float32"))
    )
    perturbed = [
        parity.wrapper_step(n, NZ, "cpu", "float32", config,
                            parity.perturb_ulp(inputs, seed))
        for seed in range(parity.SPREAD_RUNS if noisy else 0)
    ]
    tag = (f"C12x63 eager {'held_suarez' if config else 'simple'} "
           f"{'noisy' if noisy else 'smooth'}")
    if not config and not float(ref64["total_precip"].max()) > 0.0:
        raise AssertionError(f"{tag}: the saturation adjustment did not "
                             f"rain")
    compare_states(tag, got, plain32, ref64, perturbed=perturbed)


# --- phase 10b ---------------------------------------------------------------

UNIT_REPS = 10  # calls of each side of a unit's A/B (phase 10b, 23)


def leaves_of(x):
    """The tensors of an output tree, by position, in float64 (exact for
    float32): hold_replay's mapping."""
    return {str(i): t.double() for i, t in enumerate(graphs._flatten(x)[0])}


def eagerly(fn):
    """fn within graphs.eager(): the eager side of an A/B."""
    def call():
        with graphs.eager():
            return fn()

    return call


def ab_calls(tag, eager, replay, n):
    """ms per call of `eager` and of `replay` (callables of no argument),
    n of each in turns (A B B A ...) by CUDA events; returns the medians.
    The events bracket the host's launches too, so a host-paced call
    shows its host time."""
    times = {"eager": [], "replay": []}
    fns = {"eager": eager, "replay": replay}
    for i in range(n):
        for k in (("eager", "replay") if i % 2 == 0 else ("replay", "eager")):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fns[k]()
            t1.record()
            torch.cuda.synchronize()
            times[k].append(t0.elapsed_time(t1))
    med = {k: statistics.median(v) for k, v in times.items()}
    say(f"{tag} ms a call: eager {med['eager']:.3f}, replayed "
        f"{med['replay']:.3f} (medians of {n} each, in turns)")
    return med


def hold_unit(tag, unit, *args, **kwargs):
    """A jit unit on the card: its first call (warm-up, capture, replay)
    and a second replay against two eager calls (hold_replay), its ms
    eager and replayed (ab_calls), its captures and the memory they
    hold.  Returns the eager and replayed medians."""
    got = unit(*args, **kwargs)
    again_r = unit(*args, **kwargs)
    eager = unit.eager(*args, **kwargs)
    again = unit.eager(*args, **kwargs)
    torch.cuda.synchronize()
    hold_replay(tag, leaves_of(got), leaves_of(eager), leaves_of(again))
    hold_replay(f"{tag} (second replay)", leaves_of(again_r),
                leaves_of(eager), leaves_of(again))
    med = ab_calls(tag, lambda: unit.eager(*args, **kwargs),
                   lambda: unit(*args, **kwargs), UNIT_REPS)
    say(f"{tag}: {unit.captures()} capture(s) of {unit.name}, "
        f"{unit.memory() / 2**20:.2f} MiB held")
    return med


def report_units(tag):
    """Every live jit unit with a capture: its captures and the device
    memory they hold (static inputs and the graphs' pools), by unit, and
    the bound on captures a unit keeps."""
    units = sorted((u for u in graphs.units() if u.captures()),
                   key=lambda u: u.name)
    total = sum(u.memory() for u in units)
    say(f"{tag} captured units (at most {graphs.MAX_CAPTURES} graphs a "
        f"unit, the least recently used dropped beyond it): "
        + ", ".join(f"{u.name} {u.captures()} ({u.memory() / 2**20:.2f} "
                    f"MiB)" for u in units)
        + f"; {total / 2**20:.2f} MiB in all")


def unit_families(t, qv):
    """One predictor of each fit family with seeded weights on the card
    at C48 x 63 (T and q in, 126 features or channels), and the inputs
    of each jitted apply: (tag, unit, args)."""
    from fv3net_tpu_torch.fit import (
        convolutional, dense, generative, graph, precipitative, recurrent,
        reservoir)
    from fv3net_tpu_torch.fit._shared import ArrayPacker, StandardScaler
    from fv3net_tpu_torch.util.quantity import Quantity

    torch.manual_seed(0)
    dev = t.device
    nf = 2 * NZ
    cols = 6 * 48 * 48
    dims = ("tile", "z", "y", "x")
    X = {names.TEMP: Quantity(t.cpu().numpy(), dims),
         names.SPHUM: Quantity(qv.cpu().numpy(), dims)}
    X.update({"dQ1": X[names.TEMP], "dQ2": X[names.SPHUM]})
    packers = [ArrayPacker(v) for v in TRAIN_VARIABLES]
    scalers = [StandardScaler().fit(pk.to_array(X)) for pk in packers]
    mlp = dense.DenseModel(*TRAIN_VARIABLES, *packers, *scalers,
                           dense._MLP(nf, [64] * 3, nf).to(dev))
    cube = torch.randn(6, 48, 48, nf, device=dev)
    col = torch.randn(cols, nf, device=dev)
    wide = {"T": NZ, "q": NZ}

    def scaler(n):
        sc = StandardScaler()
        sc.mean, sc.std = np.zeros(n), np.ones(n)
        return sc

    conv = convolutional.ConvolutionalModel(
        ["T", "q"], ["T", "q"], wide, wide, None, None,
        convolutional._CNN(nf, 32, 2, 3, nf).to(dev), 2)
    gnn = graph.GraphModel(["T", "q"], ["T", "q"], wide, wide, None, None,
                           None, graph._GraphMPG(nf, 32, 3, nf).to(dev))
    ae = generative.AutoencoderModel(
        ["T", "q"], wide, None, generative._AE(nf, 16, 2, 8, nf).to(dev))
    gan = generative.CycleGANModel(
        ["T", "q"], ["T", "q"], wide, None, None,
        *(generative._Generator(nf, 16, 2, nf).to(dev) for _ in range(2)))
    prec = precipitative.PrecipitativeModel(
        ["T", "q"], None, None, scaler(NZ), scaler(NZ),
        precipitative._Trunk(nf, [64] * 3, NZ).to(dev), NZ)
    fmr = recurrent.FMRModel(["f"], ["T", "q"], None, None, None, None, None,
                             recurrent._FMRCore(64, nf, 2).to(dev))
    hp = reservoir.ReservoirHyperparameters()
    n_input = nf * (24 + 2 * hp.overlap) ** 2  # a 2 x 2 layout's subdomain
    res = reservoir.ReservoirComputingModel(
        ["T", "q"], ["T", "q"], hp,
        reservoir.Reservoir(hp, n_input, device=dev),
        torch.zeros(2 * hp.state_size, nf, device=dev),
        types.SimpleNamespace(n_subdomains=4), None, None)
    emulator = train_emulator({k: np.random.RandomState(0).rand(
        2048, NZ).astype(np.float32) for k in GSCOND_KEYS}, dev, epochs=1)
    n_em = emulator.module.trunk[0].in_features
    return [
        ("dense _apply", mlp._apply, (col,)),
        ("dense _dev_fn (pure_fn)", mlp._dev_fn,
         (mlp.params_on(dev), {names.TEMP: t, names.SPHUM: qv})),
        ("convolutional _apply", conv._apply, (cube,)),
        ("graph _apply", gnn._apply, (cube,)),
        ("autoencoder _apply", ae._apply, (cube,)),
        ("autoencoder _encode", ae._encode, (cube,)),
        ("cyclegan _fwd", gan._fwd, (cube,)),
        ("cyclegan _bwd", gan._bwd, (cube,)),
        ("precipitative _jit_fwd", prec._jit_fwd,
         (col, torch.rand(cols, NZ, device=dev))),
        ("fmr _jit_rollout", fmr._jit_rollout,
         (col, torch.randn(4, cols, 2, device=dev))),
        ("reservoir _step", res._step,
         (torch.randn(24, n_input, device=dev), res._x)),
        ("transformed _apply", emulator._apply,
         (torch.randn(cols, n_em, device=dev),)),
    ]


def phase_units():
    """Each unit the JAX package jits on the serving paths, on the card at
    C48 x 63 f32 (module docstring, 10b)."""
    from fv3net_tpu_torch.physics.radiation import RadiationDriver
    from fv3net_tpu_torch.runtime import steppers
    from fv3net_tpu_torch.utils.zenith import cos_zenith_angle

    n = 48
    inputs = parity.moist_inputs(n, NZ)
    wrapper.initialize(wrapper.ModelConfig(npx=n + 1, npz=NZ,
                                           physics_suite="gfs"),
                       device="cuda")
    wrapper.set_state(inputs)
    mdl = wrapper.get_model()
    st = mdl.state
    t, qv, qc, u, v, delp = (mdl._temperature(), st.q[0], st.q[1], st.u,
                             st.v, st.delp)
    tsfc = mdl._tsfc_tensor()
    pe, _ = mdl._pressure_layers(delp)
    p = 0.5 * (pe[:, 1:] + pe[:, :-1])
    gen = torch.Generator(device="cuda").manual_seed(10)

    def rand(shape, scale):
        return scale * torch.rand(shape, generator=gen, device="cuda")

    cfg = gfs.GFSPhysicsConfig()
    gfdl = gfs.GFSPhysicsConfig(convection_scheme="mass_flux",
                                microphysics_scheme="gfdl")
    mp = tuple(rand(t.shape, 1e-5) for _ in range(4))
    tag = f"C{n}x{NZ}"
    hold_unit(f"{tag} held_suarez_tendencies",
              wrapper._held_suarez_tendencies, t, u, v, pe, mdl._lat_t,
              DT_ATMOS)
    hold_unit(f"{tag} saturation_adjustment", wrapper._saturation_adjustment,
              t, qv, qc, p, delp, DT_ATMOS)
    hold_unit(f"{tag} gfs_physics_step (Zhao-Carr)", gfs.gfs_physics_step,
              t, qv, qc, u, v, delp, tsfc, PTOP, DT_ATMOS, cfg=cfg)
    hold_unit(f"{tag} gfs_physics_step (mass flux, gwd, GFDL, mp_tracers)",
              gfs.gfs_physics_step, t, qv, qc, u, v, delp, tsfc, PTOP,
              DT_ATMOS, cfg=gfdl, h_std=rand(tsfc.shape, 400.0),
              mp_tracers=mp)
    hold_unit(f"{tag} gscond", wrapper._gscond, t, qv, qc, p, DT_ATMOS)
    hold_unit(f"{tag} precpd", wrapper._precpd, t, qv, rand(t.shape, 1e-4),
              p, delp, DT_ATMOS, cfg)
    drv = RadiationDriver()
    drv.radupdate(RAD_TIME)
    cosz = np.maximum(cos_zenith_angle(
        RAD_TIME, np.rad2deg(mdl.lon), np.rad2deg(mdl.lat)), 0.0)
    hold_unit(f"{tag} gray radiation _core", drv._jit_core,
              mdl._tensor(cosz), p, delp, t, qv, tsfc,
              mdl._tensor(float(np.float32(drv._solcon))))
    hold_unit(f"{tag} non_negative_sphum", steppers._non_negative_sphum, qv,
              rand(t.shape, 1e-4) - 5e-5, rand(t.shape, 1e-7) - 5e-8,
              dt=DT_ATMOS)
    for name, unit, args in unit_families(t, qv):
        hold_unit(f"{tag} {name}", unit, *args)


class SyncTimer(timing.Timer):
    """The loop's Timer with a synchronisation before each clock read
    (entry and exit), the host clock when each "mainloop" block starts,
    and the kernel launches of each step, read when a "mainloop" block
    ends.  Within ``alternating()`` (phases 11, 13 and 15-17) the steps
    take turns: even steps replay the captured units (step 0 captures
    them), odd steps run every unit eagerly (``graphs.eager()``); the
    steps whose index is in ``traced`` run under torch.profiler, their
    device busy ms in ``busy``."""

    instances = []
    ab = False
    traced = ()

    def __init__(self):
        super().__init__()
        self.launches = []
        self.starts = []
        self.eager = []
        self.busy = {}
        SyncTimer.instances.append(self)

    @contextlib.contextmanager
    def clock(self, name):
        torch.cuda.synchronize()
        if name != "mainloop":
            with super().clock(name):
                yield
                torch.cuda.synchronize()
            return
        i = len(self.starts)
        self.eager.append(SyncTimer.ab and i % 2 == 1)
        reset_counts()
        self.starts.append(time.perf_counter())
        with contextlib.ExitStack() as stack:
            if self.eager[-1]:
                stack.enter_context(graphs.eager())
            prof = (stack.enter_context(device_profile())
                    if i in SyncTimer.traced else None)
            with super().clock(name):
                yield
                torch.cuda.synchronize()
        if prof is not None:
            self.busy[i] = device_busy_ms(prof)
        self.launches.append(read_counts())


@contextlib.contextmanager
def alternating(traced=()):
    """SyncTimers alternate replayed and eager steps within the block,
    and trace the steps `traced`."""
    SyncTimer.ab, SyncTimer.traced = True, tuple(traced)
    try:
        yield
    finally:
        SyncTimer.ab, SyncTimer.traced = False, ()


def device_profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def device_busy_ms(prof):
    """The summed device time (kernels, copies) of a profiler trace."""
    cuda_t = torch.autograd.DeviceType.CUDA
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == cuda_t) / 1e3


def ab_report(tag, timers, clocks=("mainloop",)):
    """Eager beside replayed: each clock's median ms over the untraced
    steps of each side (the first step of each TimeLoop, which captures,
    left out), and each traced step's device busy ms and idle share
    (against its own ms, and against the untraced median of its side).
    Returns {side: mainloop median}."""
    def samples(clock, eager):
        return [1e3 * tm.times[clock][i] for tm in timers
                for i, e in enumerate(tm.eager)
                if i > 0 and e == eager and i not in tm.busy]

    med = {}
    for clock in clocks:
        row = []
        for side, eager in (("eager", True), ("replayed", False)):
            got = samples(clock, eager)
            m = statistics.median(got) if got else float("nan")
            if clock == "mainloop":
                med[side] = m
            row.append(f"{side} {m:.3f} (of {len(got)}: "
                       f"{[round(t, 3) for t in got]})")
        say(f"{tag} {clock:11s} ms A/B: {'; '.join(row)}")
    for tm in timers:
        for i, busy in sorted(tm.busy.items()):
            side = "eager" if tm.eager[i] else "replayed"
            own = 1e3 * tm.times["mainloop"][i]
            say(f"{tag} traced step {i} ({side}): device busy {busy:.3f} "
                f"ms, mainloop {own:.3f} ms (traced), idle share "
                f"{1.0 - busy / own:.3f} against it, "
                f"{1.0 - busy / med[side]:.3f} against the untraced "
                f"median of its side ({med[side]:.3f} ms)")
    return med


class SyncScalarSink(timing.ScalarSink):
    """append's scalar sink, whose write ends each step's iteration (after
    the diagnostics sinks and the metrics): the host clock after each
    write, read after a synchronisation."""

    ends = []

    def write(self, step, time_, scalars):
        super().write(step, time_, scalars)
        torch.cuda.synchronize()
        SyncScalarSink.ends.append(time.perf_counter())


def phase_prognostic_run():
    """The eager prognostic run through the runfv3 CLI (module docstring,
    11).  Returns the launches of one step."""
    n = 48
    config = {
        "namelist": {"npx": n + 1, "npz": NZ, "dt_atmos": DT_ATMOS,
                     "n_split": 6, "segment_steps": PROGNOSTIC_STEPS,
                     "dtype": "float32"},
        "diagnostics": [{"name": "diags.zarr",
                         "variables": ["water_vapor_path"],
                         "times": {"kind": "every"}}],
    }
    g = CubedSphereGrid.make(n, halo=H)
    area = torch.as_tensor(np.asarray(g.area[g.interior]),
                           dtype=torch.float64, device="cuda")
    dry = []  # (before, after) float64 device sums around step_dynamics

    def dry_mass_now():
        st = wrapper.get_model().state
        return (st.delp.double() * (1.0 - st.q[0].double())
                * area[:, None]).sum()

    def step_dynamics():
        before = dry_mass_now()
        wrapper._model.step_dynamics()
        dry.append((before, dry_mass_now()))

    restored = {}

    def read_restart(wm, path):
        real_read_restart(wm, path)
        restored.update(wm.get_state(segmented_run.RESTART_NAMES + ["time"]))

    real_read_restart = segmented_run.read_restart
    patches = ((timing, "Timer", SyncTimer),
               (timing, "ScalarSink", SyncScalarSink),
               (wrapper, "step_dynamics", step_dynamics),
               (segmented_run, "read_restart", read_restart))
    originals = [getattr(mod, name) for mod, name, _ in patches]
    SyncTimer.instances.clear()
    SyncScalarSink.ends.clear()
    stack = contextlib.ExitStack()
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "fv3config.yml")
        with open(cfg_path, "w") as f:
            json.dump(config, f)  # JSON is YAML
        rundir = os.path.join(tmp, "run")
        try:
            for mod, name, fn in patches:
                setattr(mod, name, fn)
            stack.enter_context(alternating(traced=PROGNOSTIC_TRACED))
            t0 = time.perf_counter()
            if cli.main(["run-native", cfg_path, rundir]) != 0:
                raise AssertionError("run-native failed")
            say(f"C48x63 prognostic run-native ({PROGNOSTIC_STEPS} steps): "
                f"{time.perf_counter() - t0:.1f} s")
            written = wrapper.get_state(segmented_run.RESTART_NAMES
                                        + ["time"])
            t0 = time.perf_counter()
            if cli.main(["append", rundir]) != 0:
                raise AssertionError("append failed")
            say(f"C48x63 prognostic append ({PROGNOSTIC_STEPS} steps): "
                f"{time.perf_counter() - t0:.1f} s")
        finally:
            stack.close()
            for (mod, name, _), fn in zip(patches, originals):
                setattr(mod, name, fn)
        check_prognostic_files(rundir)
    timers = SyncTimer.instances
    if len(timers) != 2:
        raise AssertionError(f"{len(timers)} TimeLoops, not 2")
    launches = [c for tm in timers for c in tm.launches]
    for i, c in enumerate(launches):
        check_counts(f"C48x63 prognostic step {i}", c, LAUNCHES_PROGNOSTIC)
    report_prognostic_times(timers)
    ab_report("C48x63 prognostic", timers, ("mainloop", "dynamics",
                                            "physics"))
    mdl = wrapper.get_model()
    for k, x in mdl.state._asdict().items():
        if x is not None and not bool(torch.isfinite(x).all()):
            raise AssertionError(f"C48x63 prognostic: non-finite {k}")
    if mdl.state.w is not None or not mdl.state.delp.is_cuda:
        raise AssertionError("prognostic state: not hydrostatic on the card")
    rel = [abs(float(a) / float(b) - 1.0) for b, a in dry]
    say(f"C48x63 prognostic dry mass across step_dynamics: max relative "
        f"change {max(rel):.3e} over {len(rel)} steps (bound {MASS_BOUND})")
    if not max(rel) <= MASS_BOUND:
        raise AssertionError(f"prognostic dry mass {max(rel):.3e}")
    check_round_trip(written, restored)
    t0 = datetime.datetime.fromisoformat(wrapper.ModelConfig().initial_time)
    elapsed = (mdl.time - t0).total_seconds()
    say(f"C48x63 prognostic model time advanced {elapsed:.0f} s "
        f"({2 * PROGNOSTIC_STEPS} x {DT_ATMOS:.0f} s)")
    if elapsed != 2 * PROGNOSTIC_STEPS * DT_ATMOS:
        raise AssertionError(f"model time advanced {elapsed} s")
    return launches[-1]


def check_prognostic_files(rundir):
    """Both segments wrote RESTART, diags.zarr (water_vapor_path, one
    record a step, finite), scalars.jsonl and timing.json."""
    from fv3net_tpu_torch.io.zarr_lite import ZarrLiteStore

    for seg in ("0000", "0001"):
        d = os.path.join(rundir, "artifacts", seg)
        for name in ("RESTART", "diags.zarr", "scalars.jsonl", "timing.json"):
            if not os.path.exists(os.path.join(d, name)):
                raise AssertionError(f"segment {seg}: no {name}")
        wvp = ZarrLiteStore(os.path.join(d, "diags.zarr")).read(
            "water_vapor_path")
        if wvp.shape != (PROGNOSTIC_STEPS, 6, 48, 48) or \
                not np.isfinite(wvp).all():
            raise AssertionError(f"segment {seg}: water_vapor_path "
                                 f"{wvp.shape}")
    say(f"C48x63 prognostic segments 0000 and 0001: RESTART, diags.zarr "
        f"(water_vapor_path {PROGNOSTIC_STEPS} x [6, 48, 48], finite), "
        f"scalars.jsonl, timing.json")


def report_prognostic_times(timers):
    """ms per step and per substep: the median over the steps after the
    first of the run (each read after a synchronisation).  "step" is the
    whole iteration of append's loop: from the start of the TimeLoop's
    step to the end of its scalar write, the diagnostics sinks and the
    metrics included; "after loop" is that iteration less mainloop."""
    starts = [t for tm in timers for t in tm.starts]
    ends = SyncScalarSink.ends
    if len(ends) != len(starts):
        raise AssertionError(f"{len(ends)} scalar writes, {len(starts)} "
                             f"steps")
    mainloop = [t for tm in timers for t in tm.times["mainloop"]]
    step = [b - a for a, b in zip(starts, ends)]
    series = {"step": step, "mainloop": mainloop,
              "after loop": [s - m for s, m in zip(step, mainloop)]}
    series.update({k: [t for tm in timers for t in tm.times[k]]
                   for k in timers[0].times if k != "mainloop"})
    for name, values in series.items():
        samples = [1e3 * t for t in values][1:]
        say(f"C48x63 prognostic {name:11s} ms {statistics.median(samples):.3f}"
            f" (median of {len(samples)}: {[round(t, 3) for t in samples]})")


def check_round_trip(written, restored):
    """The state append read back from segment 0's RESTART against the
    state run-native wrote there: seven fields bit for bit, T within
    T_ULPS ulps of f32."""
    if restored["time"] != written["time"]:
        raise AssertionError("restart round trip: time differs")
    for name in segmented_run.RESTART_NAMES:
        a, b = restored[name].values, written[name].values
        if name == "air_temperature":
            ulps = float((np.abs(a.astype(np.float64) - b)
                          / np.spacing(np.abs(b))).max())
            say(f"restart round trip {name}: {ulps:.0f} ulps of f32 "
                f"(bound {T_ULPS})")
            if ulps > T_ULPS:
                raise AssertionError(f"restart round trip T: {ulps} ulps")
        elif not np.array_equal(a, b):
            raise AssertionError(f"restart round trip: {name} differs")
    say("restart round trip: delp, q, qc, u, v, tsfc, total_precip bit for "
        "bit")


# --- phases 12 and 13 -------------------------------------------------------


@contextlib.contextmanager
def gfdl_branches():
    """Record, at every call of the GFDL microphysics, on which side of
    its two discontinuous thresholds each level fell: homogeneous
    freezing of cloud liquid below T_ICE_ALL and melting of cloud ice
    above T_FREEZE, decided on the saturation adjustment's output (the
    scheme's other limiters are continuous).  Yields the list of
    [2, 6, nz, n, n] masks."""
    real = gfdl_mp.saturation_adjustment
    masks = []

    def recording(t, qv, ql, qi, p, iters=2):
        out = real(t, qv, ql, qi, p, iters)
        t2, _, ql2, qi2 = out
        frz = t2 < gfdl_mp.T_ICE_ALL
        ice = torch.where(frz, ql2, 0.0)
        t3 = t2 + gfdl_mp.LF * ice / gfdl_mp.CP_AIR
        masks.append(torch.stack([frz, t3 > gfdl_mp.T_FREEZE]).cpu())
        return out

    gfdl_mp.saturation_adjustment = recording
    try:
        # the recorder reads the host: the units run their eager bodies
        # (each replay equals its eager call, phase 10b)
        with graphs.eager():
            yield masks
    finally:
        gfdl_mp.saturation_adjustment = real


def gfdl_flips(masks_a, masks_b):
    """Columns [6, n, n] in which a GFDL branch differs between two runs."""
    flips = None
    for a, b in zip(masks_a, masks_b):
        f = (a != b).any(dim=0).any(dim=1)
        flips = f if flips is None else flips | f
    return flips


def nudged_step(n, device, dtype, root):
    """One eager step of the nudged run (a TimeLoop step with the nudger)
    at C<n> x 63 from the case under `root`, on `device` in `dtype`: the
    state, total precipitation and nudging tendencies, the physics
    diagnostics and the GFDL branch masks, on the CPU in float64."""
    wm, nudger = nudged_case.initialize(n, device, root, dtype)
    mdl = wm.get_model()
    tl = loop_mod.TimeLoop(wm, derived_state.DerivedModelState(wm),
                           mdl.config.dt_atmos, postphysics_stepper=nudger,
                           n_steps=1)
    t0 = time.perf_counter()
    with gfdl_branches() as masks:
        (_, diags), = list(tl)
    say(f"C{n}x{NZ} nudged step {device} {dtype}: "
        f"{time.perf_counter() - t0:.1f} s")
    out = {k: x.double().cpu() for k, x in mdl.state._asdict().items()}
    out["total_precip"] = mdl.total_precip.double().cpu()
    for v in (names.TEMP, names.SPHUM):
        k = f"{v}_tendency_due_to_nudging"
        out[k] = torch.as_tensor(diags[k].values).double()
    physics = {k: x.double().cpu() for k, x in mdl._physics_diags.items()}
    return out, physics, masks


def phase_nudged_parity():
    """One eager nudged step at C12 x 63 on the card against the CPU in
    f32 and float64, and gfs_physics_step with the mass flux and the
    gravity-wave drag (module docstring, 12)."""
    n = 12
    with tempfile.TemporaryDirectory() as root:
        ref64, d64, _ = nudged_step(n, "cpu", "float64", root)
        plain32, d32, m32 = nudged_step(n, "cpu", "float32", root)
        got, dgot, mgot = nudged_step(n, "cuda", "float32", root)
    for tag, x in (("f64", ref64), ("card", got)):
        if not float(x["total_precip"].max()) > 0.0:
            raise AssertionError(f"C12x63 nudged {tag}: no precipitation")
    hold_flipped("C12x63 nudged", got, plain32, ref64, {
        "gfs": flipped_columns(dgot, d32), "gfdl": gfdl_flips(mgot, m32)},
        NUDGED_FLIP_BOUND)
    # the options the wrapper does not reach, on the f64 initial state
    st = nudged_case.restart_fields(n)
    phys = []
    for device, dtype in (("cpu", torch.float64), ("cpu", torch.float32),
                          ("cuda", torch.float32)):
        def t_(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        fields = [t_(st[k].values) for k in ("T", "sphum", "liq_wat")]
        winds = [t_(st[k].values) for k in ("u", "v")]
        delp = t_(st["delp"].values)
        mp = [t_(st[k].values)
              for k in ("ice_wat", "rainwat", "snowwat", "graupel")]
        h_std = t_(400.0 * np.random.RandomState(12).rand(6, n, n))
        cfg = gfs.GFSPhysicsConfig(convection_scheme="mass_flux",
                                   microphysics_scheme="gfdl")
        with gfdl_branches() as masks:
            out, diags = gfs.gfs_physics_step(
                *fields, *winds, delp, t_(np.full((6, n, n), 300.0)),
                PTOP, DT_ATMOS, cfg=cfg, h_std=h_std, mp_tracers=mp)
        out["total_precipitation"] = diags["total_precipitation"]
        phys.append((
            {k: x.double().cpu() for k, x in out.items()},
            {k: x.double().cpu() for k, x in diags.items()}, masks))
    (r, _, _), (p, dp, mp32), (g, dg, mg) = phys
    fired = int((dg["convective_precipitation"] > 0).sum())
    say(f"C12x63 mass flux: fires in {fired} columns on the card, "
        f"{int((dp['convective_precipitation'] > 0).sum())} on the CPU; "
        f"gwd surface stress up to {float(dg['gwd_surface_stress'].max()):.3e}"
        f" Pa")
    if not fired or not float(dg["gwd_surface_stress"].max()) > 0.0:
        raise AssertionError("C12x63 mass flux / gwd: did not act")
    pc, pp = dg["convective_precipitation"], dp["convective_precipitation"]
    choice = (pc - pp).abs() > SAS_CHOICE_RTOL * torch.maximum(pc.abs(),
                                                               pp.abs())
    hold_flipped("C12x63 gfs mass flux + gwd", g, p, r, {
        "gfs": flipped_columns(dg, dp), "gfdl": gfdl_flips(mg, mp32),
        "mass flux choice": choice}, NUDGED_FLIP_BOUND)


# the C48 runs' diagnostics stores (phase 20), under the case's directory:
# per step T, q and delp, and the surface pressure, the total water path
# and the physics' precipitation rate; and the ML-corrected run's logs
DIAG_STORES = {"nudged": ("diags", "nudged.zarr"),
               "ML-corrected": ("diags", "ml.zarr")}
DIAG_LOGS = ("diags", "ml_logs")


def diag_rows(rows, state):
    """Append one step of `state` (the loop's state) to `rows` (name ->
    per-step host arrays) for a diagnostics store (DIAG_STORES)."""
    delp = np.asarray(state[names.DELP].values)
    q = np.asarray(state[names.SPHUM].values)
    for k, v in ((names.TEMP, state[names.TEMP].values), (names.SPHUM, q),
                 (names.DELP, delp),
                 (names.PHYSICS_PRECIP_RATE,
                  state[names.PHYSICS_PRECIP_RATE].values),
                 ("surface_pressure", PTOP + delp.sum(1)),
                 ("total_water_path", (q * delp).sum(1) / GRAV)):
        rows.setdefault(k, []).append(np.asarray(v))


def phase_nudged_run():
    """The nudged run at C48 x 63 on the card (module docstring, 13).
    Returns the launches of one step and the case's directory (a
    TemporaryDirectory, kept for phases 14-19)."""
    from fv3net_tpu_torch import data
    from fv3net_tpu_torch.io import restarts
    from fv3net_tpu_torch.io.zarr_lite import ZarrLiteStore

    n = 48
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    t0 = time.perf_counter()
    wm, nudger = nudged_case.initialize(n, "cuda", root)
    mdl = wm.get_model()
    say(f"C48x63 nudged: case written and model initialised from "
        f"{root}/run/INPUT in {time.perf_counter() - t0:.1f} s")
    # ingest: the card's state against the CPU's ingest of the same files
    want, phis = restarts.state_from_restarts(
        restarts.open_restarts(os.path.join(root, "run"))["INPUT"], PTOP)
    for k, w in want._asdict().items():
        if not torch.equal(getattr(mdl.state, k).cpu(), torch.as_tensor(w)):
            raise AssertionError(f"C48x63 nudged ingest: {k} differs")
    if not torch.equal(mdl.phis.cpu(), torch.as_tensor(phis)):
        raise AssertionError("C48x63 nudged ingest: phis differs")
    say(f"C48x63 nudged ingest: {', '.join(want._fields)} and phis on the "
        f"card equal the CPU's ingest bit for bit; q "
        f"{tuple(mdl.state.q.shape)}, time {mdl.time}")

    tl = loop_mod.TimeLoop(wm, derived_state.DerivedModelState(wm),
                           mdl.config.dt_atmos, postphysics_stepper=nudger,
                           n_steps=NUDGED_STEPS)
    tl.timer = SyncTimer()
    tend = [f"{v}_tendency_due_to_nudging" for v in (names.TEMP,
                                                       names.SPHUM)]
    rows = {v: [] for v in [names.TEMP, names.SPHUM] + tend}
    drows = {}
    precip_cols = []
    with budgets(mdl) as rec, alternating(traced=NUDGED_TRACED):
        for time_, diags in tl:
            for v in (names.TEMP, names.SPHUM):
                rows[v].append(tl.state[v].values)
            for v in tend:
                rows[v].append(np.asarray(diags[v].values))
            precip_cols.append(int(
                (mdl._physics_diags["large_scale_precipitation"] > 0).sum()))
            diag_rows(drows, tl.state)
    check_run("C48x63 nudged", wm, tl, rec, LAUNCHES_NUDGED,
              ("mainloop", "dynamics", "physics", "postphysics", "tracers",
               "prephysics"))
    ab_report("C48x63 nudged", [tl.timer], ("mainloop", "dynamics",
                                            "physics", "postphysics"))
    check_hydrometeors(rec["hydro"])
    say(f"C48x63 nudged GFDL precipitation > 0 in {precip_cols} of "
        f"{6 * n * n} columns (each step)")
    if not min(precip_cols) > 0:
        raise AssertionError("nudged: no GFDL precipitation")
    t_tend = rows[tend[0]]
    mean, big = float(np.mean(t_tend[0])), float(np.abs(t_tend).max())
    say(f"C48x63 nudged T tendency: mean {mean:.4e} K/s, max|.| {big:.4e} "
        f"(bound {10.0 / (3 * 3600.0):.4e})")
    if not (mean > 0.0 and big < 10.0 / (3 * 3600.0)):
        raise AssertionError("nudged T tendency out of bounds")
    # the stores the nudged run ships, and the training batches
    out = os.path.join(root, "out")
    dims = ("time", "tile", "z", "y", "x")
    for zarr, group in (("state_after_timestep.zarr",
                         [names.TEMP, names.SPHUM]),
                        ("nudging_tendencies.zarr", tend)):
        store = ZarrLiteStore(os.path.join(out, zarr))
        for v in group:
            arr = np.stack(rows[v]).astype(np.float32)
            store.create_array(v, shape=arr.shape,
                               chunks=(1,) + arr.shape[1:],
                               dtype=np.float32, dims=dims)
            store.write_full(v, arr)
    mapper = data.open_nudge_to_fine(out)
    first = mapper[sorted(mapper.keys())[0]]
    if not np.array_equal(first["dQ1"].values,
                          t_tend[0].astype(np.float32)):
        raise AssertionError("nudged: the mapper's dQ1 differs")
    batches = data.batches_from_mapper(
        "open_nudge_to_fine", {"url": out},
        variable_names=[names.TEMP, "dQ1", "dQ2"])
    say(f"C48x63 nudged: open_nudge_to_fine {len(mapper)} times, dQ1 bit "
        f"for bit; batches_from_mapper {len(batches)} batches of "
        f"{sorted(batches[0])}")
    if len(batches) != NUDGED_STEPS:
        raise AssertionError(f"nudged: {len(batches)} batches")
    write_store(os.path.join(root, *DIAG_STORES["nudged"]), drows)
    return tl.timer.launches[-1], tmp


def check_hydrometeors(hydro):
    """The physics makes no hydrometeor more negative than it found it,
    and the negative mass the dycore leaves in each species is at most
    UNDERSHOOT_BOUND of its positive mass (phase 13)."""
    worst = torch.zeros(5, dtype=torch.float64)
    for qmin, after, neg, pos in hydro:
        if bool((after < torch.clamp_max(qmin, 0.0)).any()):
            raise AssertionError(f"nudged physics: hydrometeor minima "
                                 f"{after.tolist()} below {qmin.tolist()}")
        worst = torch.maximum(worst, (-neg / pos.clamp_min(1e-300)).cpu())
    fmt = lambda xs: [f"{float(x):.3e}" for x in xs]  # noqa: E731
    say(f"C48x63 nudged hydrometeors (liquid, ice, rain, snow, graupel): "
        f"minima before physics {fmt(hydro[-1][0])}, after "
        f"{fmt(hydro[-1][1])}; negative mass after the dycore at most "
        f"{fmt(worst)} of the positive mass (bound {UNDERSHOOT_BOUND})")
    if not float(worst.max()) <= UNDERSHOOT_BOUND:
        raise AssertionError(f"nudged undershoot {float(worst.max()):.3e}")


# --- phases 14, 15 and 16 ---------------------------------------------------


TRAIN_VARIABLES = ([names.TEMP, names.SPHUM], ["dQ1", "dQ2"])
HELD_STEPS = (1, 10)  # Adam steps held against the CPU (phase 14)
ML_STEPS = 4  # TimeLoop steps of the ML-corrected run (phase 15)
STORED_STEPS, EMULATED_STEPS = 4, 3  # phase 16: storage steps, emulated
# ... the emulated run's launches: the nudged case's dycore (six species)
LAUNCHES_ML = LAUNCHES_EMULATED = LAUNCHES_NUDGED
# phase 16's gscond emulator: tests/test_transformed_training.py's spec
# (T and q differences, their loss, epochs, batches and learning rate;
# lines 160-185) at the family's default architecture (dense, depth 2,
# width 256), with one change: the cloud enters as itself, not as
# log(cloud + 1e-10), since the dycore's tracer transport leaves cloud
# below -1e-10 (phase 13), where the log is NaN
EMULATOR_SPEC = [
    {"to": "tdiff", "before": "air_temperature_input",
     "after": "air_temperature_after_gscond"},
    {"to": "qvdiff", "before": "specific_humidity_input",
     "after": "specific_humidity_after_gscond"},
]
EMULATOR = dict(
    tensor_transform=EMULATOR_SPEC,
    model={"input_variables": ["air_temperature_input",
                               "specific_humidity_input",
                               "cloud_water_mixing_ratio_input"],
           "direct_out_variables": ["tdiff", "qvdiff"]},
    loss={"loss_variables": ["tdiff", "qvdiff"]},
    epochs=50, batch_size=256, learning_rate=1e-3,
)
# the hook writes "<name>_output" and apply_physics reads the outputs under
# the state's names: a DerivedModel gives the emulator's *_after_gscond
# predictions those names (fv3net_tpu_torch.emulation.gscond, ROADMAP
# quirk (m)); the emulator conserves water
GSCOND_KEYS = tuple(f"{v}_{s}" for v in gscond.EMULATED
                    for s in ("input", "after_gscond"))
CLOUD_BOUND = -1e-10  # cloud water after apply_physics (phase 16)
HOLD_ROWS = 4096  # the fixed batch the held models predict (phase 14)
# the sides of a training A/B in turns (phases 14, 16, 18)
AB_TRAINING = ("eager", "replay", "eager")
# the epochs of the dense, transformed, FMR and CycleGAN trainings of an
# A/B (the others' defaults take under a second)
AB_EPOCHS = 5


class TrainClock:
    """Replaces fit._shared.run_steps and run_rounds, the loops of
    training steps: each call timed between one pair of synchronisations,
    its steps' losses read after it (nothing in the loop waits for the
    card).  `seconds`, `steps` and `loss` (host floats) over every call;
    `captures` and `memory`, the graphs the loops' training steps
    (fit._shared.training_step) captured and the device bytes they held, read as
    each loop ends; `capture_seconds`, the part of `seconds` the
    captures took (each timed after a synchronisation)."""

    LOOPS = ("run_steps", "run_rounds")

    def __init__(self):
        self.seconds, self.loss = 0.0, []
        self.captures = self.memory = 0
        self.capture_seconds = 0.0

    @property
    def steps(self):
        return len(self.loss)

    def __enter__(self):
        from fv3net_tpu_torch.fit import _shared

        self.real = {k: getattr(_shared, k) for k in self.LOOPS}
        self.real_step = real_step = _shared.training_step
        self.real_capture = graphs._Capture
        made = []
        clock = self

        def recorded(*args):
            made.append(real_step(*args))
            return made[-1]

        class Timed(graphs._Capture):
            def __init__(self, *args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                super().__init__(*args, **kwargs)
                clock.capture_seconds += time.perf_counter() - t0

        def timed(real):
            def loop(*args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses = real(*args)
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                self.loss += (torch.stack(losses).cpu().tolist() if losses
                              else [])
                self.captures += sum(u.captures() for u in made)
                self.memory += sum(u.memory() for u in made)
                made.clear()
                return losses
            return loop

        _shared.training_step = recorded
        graphs._Capture = Timed
        for k, real in self.real.items():
            setattr(_shared, k, timed(real))
        return self

    def __exit__(self, *exc):
        from fv3net_tpu_torch.fit import _shared

        _shared.training_step = self.real_step
        graphs._Capture = self.real_capture
        for k, real in self.real.items():
            setattr(_shared, k, real)

    def report(self, samples):
        """ms per step and samples/s over the loop's time (`samples` the
        samples of all its epochs)."""
        return (f"ms per step {1e3 * self.seconds / self.steps:.4f} "
                f"({self.steps} steps in {self.seconds:.4f} s), samples/s "
                f"{samples / self.seconds:.1f}")


class StepClock:
    """Wraps each training step fit._shared.training_step makes, eager or
    replayed: each step between two synchronisations and its ms
    recorded, a per-layer statistic (the loop's own time is
    TrainClock's)."""

    def __init__(self):
        self.ms = []

    def __enter__(self):
        from fv3net_tpu_torch.fit import _shared

        self.real = real = _shared.training_step

        def made(*args):
            unit = real(*args)

            def step(batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = unit(batch)
                torch.cuda.synchronize()
                self.ms.append((time.perf_counter() - t0) * 1e3)
                return loss
            return step

        _shared.training_step = made
        return self

    def __exit__(self, *exc):
        from fv3net_tpu_torch.fit import _shared

        _shared.training_step = self.real


def side_of(side):
    """The context of one side of an A/B: graphs.eager() for "eager"."""
    return graphs.eager() if side == "eager" else contextlib.nullcontext()


def ab_training(tag, train, samples, unit):
    """`train()` (a family's training on the card; returns the model)
    eager (within graphs.eager()) and replayed, in turns (AB_TRAINING:
    eager, replayed, eager): each side's ms per step and samples/s over
    its loops (TrainClock; `samples` those of one training, in `unit`),
    the replayed run's parameters and every step's loss held against the
    eager runs' (hold_replay: bit for bit where the two eager runs agree,
    else within their spread), the replayed loop's captures and the
    memory they held, and the A/B's own seconds.  Returns the medians of
    ms per step, eager and replayed."""
    t0 = time.perf_counter()
    runs = {"eager": [], "replay": []}
    for side in AB_TRAINING:
        with TrainClock() as clock, side_of(side):
            model = train()
        runs[side].append((clock, dict(model_params(model), loss=torch.tensor(
            clock.loss, dtype=torch.float64))))
    (_, eager), (_, again) = runs["eager"]
    for i, (_, got) in enumerate(runs["replay"]):
        hold_replay(f"{tag} replayed run {i + 1}", got, eager, again)
    clocks = {k: [c for c, _ in v] for k, v in runs.items()}
    if any(c.captures for c in clocks["eager"]) or not all(
            c.captures for c in clocks["replay"]):
        raise AssertionError(f"{tag}: captures eager "
                             f"{[c.captures for c in clocks['eager']]}, "
                             f"replayed "
                             f"{[c.captures for c in clocks['replay']]}")
    ms = {k: [1e3 * c.seconds / c.steps for c in v]
          for k, v in clocks.items()}
    med = {k: statistics.median(v) for k, v in ms.items()}
    rate = {k: samples / statistics.median(c.seconds for c in v)
            for k, v in clocks.items()}
    # the replayed loop without its captures' seconds: what each later
    # training of the same shapes would pay if the graphs were kept
    bare = [1e3 * (c.seconds - c.capture_seconds) / c.steps
            for c in clocks["replay"]]
    rep = clocks["replay"][0]
    say(f"{tag} A/B ({', '.join(AB_TRAINING)}; {rep.steps} steps a run): "
        f"ms per step eager {med['eager']:.4f} "
        f"{[round(t, 4) for t in ms['eager']]}, replayed "
        f"{med['replay']:.4f} {[round(t, 4) for t in ms['replay']]} "
        f"(without the captures' "
        f"{[round(c.capture_seconds, 3) for c in clocks['replay']]} s: "
        f"{[round(t, 4) for t in bare]}); samples/s eager "
        f"{rate['eager']:.1f}, replayed {rate['replay']:.1f} (samples: "
        f"{unit}); the replayed loop's captures {rep.captures}, "
        f"{rep.memory / 2**20:.2f} MiB held; the A/B "
        f"{time.perf_counter() - t0:.1f} s")
    return med


def model_params(model):
    """A trained model's parameters, "layer.bias"/"layer.kernel" -> tensor
    (flax names; CycleGAN's two generators prefixed "G_ab/", "G_ba/")."""
    from fv3net_tpu_torch.convert import module_flax_params

    modules = ({"G_ab/": model.gen_ab, "G_ba/": model.gen_ba}
               if hasattr(model, "gen_ab") else {"": model.module})
    return {f"{pre}{layer}.{k}": torch.as_tensor(v)
            for pre, m in modules.items()
            for layer, p in module_flax_params(m).items()
            for k, v in p.items()}


def hold_training(tag, train, batch, steps_batch, predict, lr,
                  perturb=parity.perturb_ulp, per_step=1):
    """One Adam step and the first 10 (HELD_STEPS) of `train(batch,
    device, steps)` on the card against the CPU from the same init and
    data, by the f32 spread of the CPU's f32 run against runs from
    parity.SPREAD_RUNS 1-ulp perturbations of the inputs
    (parity.f32_rule): the parameters leaf by leaf, and the predictions
    `predict(model)` (name -> array) on a fixed batch output by output.
    A 1-ulp input change moves a few parameter elements by a good part of
    an Adam step (`lr`): they set their leaf's bound, and they are
    counted.  The
    predictions sum over every parameter, so their bound stays tight.
    `batch` holds arrays; with `steps_batch` each hold trains on the first
    steps x steps_batch rows of each, one epoch, else on all of them (the
    train function sets its epochs from `steps`); `perturb(batch, seed)`
    moves every value of it by one ulp.  `per_step`: optimiser steps a
    held step (2 for CycleGAN's generator and discriminator steps)."""

    def outputs(model):
        return model_params(model), {k: torch.as_tensor(np.asarray(v))
                                     for k, v in predict(model).items()}

    for steps in HELD_STEPS:
        sub = batch if steps_batch is None else {
            k: v[: steps * steps_batch] for k, v in batch.items()}
        with TrainClock() as clock:
            got = outputs(train(sub, "cuda", steps))
        if clock.steps != steps * per_step:
            raise AssertionError(f"{tag}: {clock.steps} steps, not {steps}")
        cpu = outputs(train(sub, "cpu", steps))
        runs = [outputs(train(perturb(sub, s), "cpu", steps))
                for s in range(parity.SPREAD_RUNS)]
        moved = sum(int((torch.stack([(r[0][k].double() - v.double()).abs()
                                      for r in runs]).amax(0)
                         > 0.1 * lr).sum()) for k, v in cpu[0].items())
        size = sum(v.numel() for v in cpu[0].values())
        for what, i in (("parameters", 0), ("predictions", 1)):
            held = parity.f32_rule(got[i], [r[i] for r in runs], cpu[i])
            for k, (err, bnd, _, errs, finite) in held.items():
                if not (finite and err <= bnd):
                    raise AssertionError(
                        f"{tag} after {steps} steps: {what} {k} {err:.3e} "
                        f"> {bnd:.3e} (spread {errs})")
            say(f"{tag}: {steps} Adam step(s) on the card against the CPU, "
                f"{what} (card - CPU, bound, max|CPU|): " + ", ".join(
                    f"{k} {e:.3e} {b:.3e} {s:.3e}"
                    for k, (e, b, s, _, _) in held.items()))
        say(f"{tag}: {steps} Adam step(s): a 1-ulp input change moved "
            f"{moved} of {size} parameters by more than a tenth of one "
            f"step (lr {lr:g})")


def train_dense_held(batch_q, device):
    from fv3net_tpu_torch import fit

    return fit.train_dense_model(
        fit.DenseHyperparameters(epochs=1), [batch_q],
        input_variables=TRAIN_VARIABLES[0],
        output_variables=TRAIN_VARIABLES[1], device=device)


def phase_training(root):
    """The train CLI at full width on the nudged run's stores (module
    docstring, 14).  Returns the model's directory."""
    from fv3net_tpu_torch import data, fit
    from fv3net_tpu_torch.fit import train as fit_train
    from fv3net_tpu_torch.util.quantity import Quantity

    out = os.path.join(root, "out")
    data_cfg = {"function": "batches_from_mapper", "kwargs": {
        "mapper_function": "open_nudge_to_fine",
        "mapper_kwargs": {"url": out},
        "variable_names": sum(TRAIN_VARIABLES, [])}}
    train_cfg = {"model_type": "dense", "hyperparameters": {},
                 "input_variables": TRAIN_VARIABLES[0],
                 "output_variables": TRAIN_VARIABLES[1]}
    paths = {}
    for name, cfg in (("training", train_cfg), ("data", data_cfg)):
        paths[name] = os.path.join(root, f"{name}.yml")
        with open(paths[name], "w") as f:
            json.dump(cfg, f)  # JSON is YAML
    model_dir = os.path.join(root, "dense_model")
    hp = fit.DenseHyperparameters()
    batches = data.open_batches_from_config(data_cfg)
    nsamp = sum(b[names.TEMP].shape[0] * b[names.TEMP].shape[2]
                * b[names.TEMP].shape[3] for b in batches)
    nfeat = sum(b[v].shape[1] for b in batches[:1]
                for v in TRAIN_VARIABLES[0])
    t0 = time.perf_counter()
    with TrainClock() as clock:
        fit_train.main([paths["training"], paths["data"], model_dir,
                        "--device", "cuda"])
    wall = time.perf_counter() - t0
    per_epoch = -(-nsamp // hp.batch_size)
    if clock.steps != hp.epochs * per_epoch:
        raise AssertionError(f"training: {clock.steps} steps")
    epochs = [float(np.mean(clock.loss[i:i + per_epoch]))
              for i in range(0, clock.steps, per_epoch)]
    say(f"C48 training (train CLI, dense depth {hp.depth} width {hp.width}, "
        f"{len(batches)} batches, {nsamp} samples of {nfeat} features, "
        f"{hp.epochs} epochs of {per_epoch} steps of {hp.batch_size}): "
        f"{clock.report(hp.epochs * nsamp)}; whole CLI {wall:.1f} s "
        f"({hp.epochs * nsamp / wall:.1f} samples/s)")
    say(f"C48 training mean loss: first epoch {epochs[0]:.6e}, last epoch "
        f"{epochs[-1]:.6e} (each epoch: {[round(e, 6) for e in epochs]})")
    if not epochs[-1] < epochs[0]:
        raise AssertionError(f"training loss did not fall: {epochs}")
    # the samples as the CLI packs them: one step and the first ten
    # against the CPU, and one epoch with every step between
    # synchronisations (a per-layer statistic)
    packers = [fit.ArrayPacker(v) for v in TRAIN_VARIABLES]
    X, Y = (np.concatenate([p.to_array(b) for b in batches])
            for p in packers)
    dims = ("sample", "z")
    rows = {v: a for p, M in zip(packers, (X, Y))
            for v, a in zip(p.names, np.split(M, len(p.names), axis=1))}
    fixed = {v: Quantity(rows[v][-HOLD_ROWS:], dims)
             for v in TRAIN_VARIABLES[0]}
    hold_training(
        "C48 dense training", lambda b, device, steps: train_dense_held(
            {k: Quantity(v, dims) for k, v in b.items()}, device),
        rows, hp.batch_size,
        lambda m: {k: q.data for k, q in m.predict(fixed).items()},
        hp.learning_rate)
    # the CLI's loop again (AB_EPOCHS of it), eager and replayed in turns
    ab_training(
        "C48 dense training", lambda: fit.train_dense_model(
            dataclasses.replace(hp, epochs=AB_EPOCHS), batches,
            input_variables=TRAIN_VARIABLES[0],
            output_variables=TRAIN_VARIABLES[1], device="cuda"),
        AB_EPOCHS * nsamp, f"columns, {AB_EPOCHS} epochs")
    for side in ("eager", "replay"):
        with StepClock() as steps, side_of(side):
            train_dense_held({k: Quantity(v, dims) for k, v in rows.items()},
                             "cuda")
        say(f"C48 dense training step alone, {side} (one epoch, each step "
            f"between synchronisations): ms "
            f"{statistics.median(steps.ms):.4f} (median of {len(steps.ms)}, "
            f"{min(steps.ms):.4f}-{max(steps.ms):.4f})")
    train_convolutional(batches)
    return model_dir


def train_convolutional(batches):
    """The convolutional family on the same batches (one cube a step, at
    ConvolutionalHyperparameters' defaults): ms per step, the loss, and
    the halo append's forward and backward alone (autograd's scatter-add
    through the exchange's gather) at the step's shape."""
    from fv3net_tpu_torch import fit

    hp = fit.ConvolutionalHyperparameters()
    with TrainClock() as clock:
        model = fit.train_convolutional_model(
            hp, batches, input_variables=TRAIN_VARIABLES[0],
            output_variables=TRAIN_VARIABLES[1], device="cuda")
    n = len(batches)
    if clock.steps != hp.epochs * n:
        raise AssertionError(f"convolutional training: {clock.steps} steps")
    first, last = np.mean(clock.loss[:n]), np.mean(clock.loss[-n:])
    x = torch.randn(6, 48, 48, model.module.convs[0].in_channels,
                    device="cuda", requires_grad=True)
    h = model.n_halo
    ct = torch.randn(6, 48 + 2 * h, 48 + 2 * h, x.shape[-1], device="cuda")

    def halo_fwd_bwd():
        x.grad = None
        (fit.append_halos(x, h) * ct).sum().backward()

    halo_ms = cuda_ms(halo_fwd_bwd)
    fwd_ms = cuda_ms(lambda: fit.append_halos(x.detach(), h))
    say(f"C48 convolutional training (filters {hp.filters}, depth "
        f"{hp.depth}, kernel {hp.kernel_size}, halo {h}, {hp.epochs} "
        f"epochs of {n} cubes): {clock.report(hp.epochs * n * 6 * 48 * 48)}"
        f" (samples: columns); "
        f"mean loss first epoch {first:.6e}, last {last:.6e}; "
        f"append_halos on [6, 48, 48, {x.shape[-1]}]: forward "
        f"{fwd_ms:.4f} ms, forward + backward {halo_ms:.4f} ms")
    if not (last < first and all(bool(torch.isfinite(p).all())
                                  for p in model.module.parameters())):
        raise AssertionError(f"convolutional training: {first} {last}")
    ab_training(
        "C48 convolutional training", lambda: fit.train_convolutional_model(
            hp, batches, input_variables=TRAIN_VARIABLES[0],
            output_variables=TRAIN_VARIABLES[1], device="cuda"),
        hp.epochs * n * 6 * 48 * 48, "columns")


@contextlib.contextmanager
def budgets(mdl):
    """wrapper.step_dynamics and apply_physics patched to record, each
    step: the dry mass before and after step_dynamics ("dry"), the column
    water (six species + precipitation) before and after apply_physics
    with the surface evaporation of the step ("water"), and the
    hydrometeors' minima before and after apply_physics with their
    negative and positive mass before it ("hydro"; phases 13, 15, 16).
    Yields the dict of lists."""
    from fv3net_tpu_torch.constants import LATENT_HEAT_VAPORIZATION

    area = torch.as_tensor(mdl.area, dtype=torch.float64, device="cuda")
    rec = {"dry": [], "water": [], "hydro": []}

    def dry_mass_now():
        st = mdl.state
        return (st.delp.double() * (1.0 - st.q.double().sum(0))
                * area[:, None]).sum()

    def water_now():
        st = mdl.state
        return ((st.q.double().sum(0) * st.delp.double() / GRAV).sum(1)
                * area).sum() + 1000.0 * (mdl.total_precip * area).sum()

    def q_min():
        return mdl.state.q[1:].amin(dim=(1, 2, 3, 4))

    def q_mass(sign):  # [5] float64: sum(q+ or q-) dp area per species
        q = mdl.state.q[1:].double()
        q = q.clamp_min(0.0) if sign > 0 else q.clamp_max(0.0)
        return (q * mdl.state.delp.double() * area[:, None]).sum(
            dim=(1, 2, 3, 4))

    def step_dynamics():
        before = dry_mass_now()
        real[0]()
        rec["dry"].append((before, dry_mass_now()))

    def apply_physics():
        before, qmin = water_now(), q_min()
        neg, pos = q_mass(-1), q_mass(1)
        real[1]()
        evap = (mdl._physics_diags["latent_heat_flux"].double() * area).sum()
        evap = evap / LATENT_HEAT_VAPORIZATION * mdl.config.dt_atmos
        rec["water"].append((before, water_now(), evap))
        rec["hydro"].append((qmin, q_min(), neg, pos))

    real = (wrapper.step_dynamics, wrapper.apply_physics)
    wrapper.step_dynamics, wrapper.apply_physics = step_dynamics, apply_physics
    try:
        yield rec
    finally:
        wrapper.step_dynamics, wrapper.apply_physics = real


def check_run(tag, wm, tl, rec, expected,
              clocks=("mainloop", "dynamics", "physics", "postphysics")):
    """Launches (`expected`) and ms of each step (the loop's SyncTimer;
    the median after the first step), a finite state, dry mass across
    step_dynamics (MASS_BOUND) and column water across apply_physics
    (WATER_BOUND) from `rec` (budgets)."""
    for i, c in enumerate(tl.timer.launches):
        if i < 4:
            check_counts(f"{tag} step {i}", c, expected)
        elif c != expected:
            raise AssertionError(f"{tag} step {i}: launches {c}")
    for name in clocks:
        samples = [1e3 * t for t in tl.timer.times[name]][1:]
        shown = ([round(t, 3) for t in samples] if len(samples) <= 8 else
                 f"{min(samples):.3f}-{max(samples):.3f}")
        say(f"{tag} {name:11s} ms {statistics.median(samples):.3f} (median "
            f"of {len(samples)}: {shown})")
    for k, x in wm.get_model().state._asdict().items():
        if x is not None and not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{tag}: non-finite {k}")
    rel = [abs(float(a) / float(b) - 1.0) for b, a in rec["dry"]]
    res = [abs(float(b - a - e) / float(a)) for a, b, e in rec["water"]]
    say(f"{tag}: dry mass across step_dynamics {max(rel):.3e} (bound "
        f"{MASS_BOUND}), column water (six species + precipitation - "
        f"evaporation) across apply_physics {max(res):.3e} (bound "
        f"{WATER_BOUND}), {len(rel)} steps")
    if not (max(rel) <= MASS_BOUND and max(res) <= WATER_BOUND):
        raise AssertionError(f"{tag}: budgets {max(rel)} {max(res)}")


class F64Dense:
    """A dense model's chain in float64 on the CPU: the float64 reference
    of its predictions (phase 15) and of its column Jacobian (phase 19)."""

    def __init__(self, model):
        import copy

        self.model = model
        self.input_variables = model.input_variables
        self.output_variables = model.output_variables
        self.module = copy.deepcopy(model.module).cpu().double()

    def predict(self, X):
        m = self.model
        x = m.scaler_in.normalize(m.packer_in.to_array(X).astype(np.float64))
        with torch.no_grad():
            yn = self.module(torch.as_tensor(x)).numpy()
        return m.packer_out.to_state(m.scaler_out.denormalize(yn),
                                     m._templates(X))


def dense_reference(model_cpu, inputs):
    """The CPU's float32 prediction and a float64 one (F64Dense) of dQ1
    and dQ2 from `inputs` (name -> host array), each through the
    stepper's humidity limiter."""
    from fv3net_tpu_torch.runtime.steppers import non_negative_sphum
    from fv3net_tpu_torch.util.quantity import Quantity

    dims = ("tile", "z", "y", "x")
    X = {k: Quantity(v, dims) for k, v in inputs.items()}
    pred32 = model_cpu.predict(X)
    pred64 = F64Dense(model_cpu).predict(X)
    out = []
    for p in (pred32, pred64):
        q = torch.as_tensor(inputs[names.SPHUM], dtype=torch.float64)
        d1, d2 = non_negative_sphum(
            q, *(torch.as_tensor(p[k].values, dtype=torch.float64)
                 for k in ("dQ1", "dQ2")), dt=DT_ATMOS)
        out.append({"dQ1": d1, "dQ2": d2})
    return out


class FirstCall:
    """A postphysics stepper that records its first call's inputs (host
    arrays) and the tendencies it returns (float64, on the CPU)."""

    def __init__(self, stepper, input_variables):
        self.stepper = stepper
        self.label = stepper.label
        self.input_variables = input_variables
        self.first = None

    def __call__(self, time_, state):
        out = self.stepper(time_, state)
        if self.first is None:
            self.first = (
                {k: state[k].values for k in self.input_variables},
                {k: torch.as_tensor(q.data).double().cpu()
                 for k, q in out[0].items()})
        return out

    def __getattr__(self, name):
        return getattr(self.stepper, name)


def phase_ml_run(root, model_dir):
    """The ML-corrected C48 run with the trained model (module
    docstring, 15).  Returns the launches of one step."""
    from fv3net_tpu_torch import fit
    from fv3net_tpu_torch.runtime import steppers

    model = fit.load(model_dir)  # no device: the card, as a user's run
    devices = {p.device.type for p in model.module.parameters()}
    if devices != {"cuda"}:
        raise AssertionError(f"fit.load put the model on {devices}")
    wm, _ = nudged_case.initialize(48, "cuda", root)
    mdl = wm.get_model()
    stepper = FirstCall(steppers.PureMLStepper(model, dt=mdl.config.dt_atmos),
                        model.input_variables)
    tl = loop_mod.TimeLoop(wm, derived_state.DerivedModelState(wm),
                           mdl.config.dt_atmos, postphysics_stepper=stepper,
                           n_steps=ML_STEPS)
    tl.timer = SyncTimer()
    drows = {}
    logs = os.path.join(root, *DIAG_LOGS)
    sink = timing.ScalarSink(logs)
    with budgets(mdl) as rec, alternating():
        for step, (time_, _) in enumerate(tl):
            diag_rows(drows, tl.state)
            sink.write(step, time_, {
                k: float(np.mean(v[-1])) for k, v in drows.items()
                if v[-1].ndim == 3})
    sink.close()
    check_run("C48x63 ML-corrected", wm, tl, rec, LAUNCHES_ML)
    ab_report("C48x63 ML-corrected", [tl.timer], ("mainloop", "physics",
                                                  "postphysics"))
    report_units("C48x63 ML-corrected")
    write_store(os.path.join(root, *DIAG_STORES["ML-corrected"]), drows)
    timing.write_timing_json(tl.timer, logs)
    # the humidity limiter: no humidity below 0 where the tendency dries
    inputs, applied = stepper.first
    drying = applied["dQ2"].numpy() < 0
    q_after = (inputs[names.SPHUM] + DT_ATMOS * applied["dQ2"].numpy())
    low = float(q_after[drying].min()) if drying.any() else 0.0
    say(f"C48x63 ML-corrected: dQ2 dries {int(drying.sum())} of "
        f"{drying.size} cells, q + dQ2 dt there >= {low:.3e}; q after "
        f"{ML_STEPS} steps >= {float(mdl.state.q[0].min()):.3e}")
    if not low >= 0.0:
        raise AssertionError("ML-corrected: the limiter left q < 0")
    cpu32, ref64 = dense_reference(fit.load(model_dir, "cpu"), inputs)
    for k, (err, bnd, scale, errs, finite) in parity.f32_rule(
            applied, [cpu32], ref64).items():
        say(f"C48x63 ML-corrected step 0 applied {k}: card vs f64 "
            f"{err:.3e} (bound {bnd:.3e}, CPU f32 {errs[0]:.3e}, scale "
            f"{scale:.3e})")
        if not (finite and err <= bnd):
            raise AssertionError(f"ML-corrected {k}: {err} > {bnd}")
    return tl.timer.launches[-1]


def gscond_batch(store, steps):
    """The stored gscond inputs and outputs (GSCOND_KEYS) of `steps` as
    one dict of [sample, z] float32 columns."""
    return {k: np.concatenate([
        np.moveaxis(store.read(k)[t], 1, -1).reshape(-1, NZ)
        for t in steps]) for k in GSCOND_KEYS}


def train_emulator(batch, device, epochs=None):
    from fv3net_tpu_torch.fit import transformed

    hp = transformed.TransformedParameters.from_dict(
        dict(EMULATOR, epochs=EMULATOR["epochs"] if epochs is None
             else epochs))
    return transformed.train_transformed(hp, [batch], device=device)


def phase_emulated_run(root):
    """The emulated C48 run (module docstring, 16).  Returns the launches
    of one emulated step."""
    from fv3net_tpu_torch import emulation, fit
    from fv3net_tpu_torch.io.zarr_lite import ZarrLiteStore
    from fv3net_tpu_torch.util.quantity import Quantity

    def run(hooks, n_steps, tag):
        wm, _ = nudged_case.initialize(48, "cuda", root)
        mdl = wm.get_model()
        mdl.emulation_hooks = hooks
        tl = loop_mod.TimeLoop(wm, derived_state.DerivedModelState(wm),
                               mdl.config.dt_atmos, n_steps=n_steps)
        tl.timer = SyncTimer()
        with budgets(mdl) as rec, alternating():
            for _ in tl:
                pass
        check_run(tag, wm, tl, rec, LAUNCHES_EMULATED)
        ab_report(tag, [tl.timer], ("mainloop", "physics"))
        report_units(tag)
        # the cloud water's minimum after each apply_physics
        return tl, [float(after[0]) for _, after, _, _ in rec["hydro"]]

    store_dir = os.path.join(root, "emulation")
    os.makedirs(store_dir)
    with contextlib.chdir(store_dir):  # the storage hook writes to "."
        run(emulation.get_hooks(emulation.EmulationConfig(
            storage=emulation.StorageConfig(output_freq_sec=int(DT_ATMOS)))),
            STORED_STEPS, "C48x63 storage (Zhao-Carr gscond)")
    store = ZarrLiteStore(os.path.join(store_dir, "state_output.zarr"))
    stored = store.read(GSCOND_KEYS[0]).shape[0]
    if stored != STORED_STEPS:
        raise AssertionError(f"storage hook: {stored} steps stored")
    train = gscond_batch(store, range(STORED_STEPS - 1))
    held = gscond_batch(store, [STORED_STEPS - 1])
    cond = np.abs(train["cloud_water_mixing_ratio_after_gscond"]
                  - train["cloud_water_mixing_ratio_input"]) > 1e-15
    say(f"C48x63 storage: {stored} steps of {sorted(store.arrays())}; "
        f"gscond changes the cloud in {int(cond.sum())} of {cond.size} "
        f"training cells")
    if not cond.any():
        raise AssertionError("emulated run: the stored state does not "
                             "condense")
    fixed = {k: Quantity(train[k][-HOLD_ROWS:], ("sample", "z"))
             for k in GSCOND_KEYS if k.endswith("_input")}
    # the emulator learns the differences of the input and after-gscond
    # snapshots, zero where gscond left a cell as it was: both snapshots
    # of a field move in the same direction, so those zeros stay zeros
    hold_training("C48 transformed training",
                  lambda b, device, steps: train_emulator(b, device,
                                                          epochs=1),
                  train, EMULATOR["batch_size"],
                  lambda m: {k: q.data for k, q in m.predict(fixed).items()},
                  EMULATOR["learning_rate"],
                  lambda b, seed: parity.perturb_ulp_grouped(
                      b, seed, lambda k: re.sub("_(input|after_gscond)$",
                                                "", k)))
    t0 = time.perf_counter()
    with TrainClock() as clock:
        emulator = train_emulator(train, "cuda")
    wall = time.perf_counter() - t0
    nsamp = len(train[GSCOND_KEYS[0]])
    per_epoch = -(-nsamp // EMULATOR["batch_size"])
    if clock.steps != EMULATOR["epochs"] * per_epoch:
        raise AssertionError(f"transformed training: {clock.steps} steps")
    say(f"C48 transformed training (dense depth 2 width 256, {nsamp} "
        f"columns, {EMULATOR['epochs']} epochs of {per_epoch} steps of "
        f"{EMULATOR['batch_size']}): "
        f"{clock.report(EMULATOR['epochs'] * nsamp)}; {wall:.1f} s with "
        f"its set-up; mean loss first epoch "
        f"{np.mean(clock.loss[:per_epoch]):.6e}, last "
        f"{np.mean(clock.loss[-per_epoch:]):.6e}")
    ab_training("C48 transformed training", lambda: train_emulator(
        train, "cuda", epochs=AB_EPOCHS),
        AB_EPOCHS * nsamp, f"columns, {AB_EPOCHS} epochs")
    path = os.path.join(root, "gscond_emulator")
    fit.dump(fit.DerivedModel(emulator, list(gscond.EMULATED)), path)
    # the held-out step: the emulator's error against no change; then the
    # emulated run, the emulator's outputs under the state's names
    with gscond.named_outputs():
        loaded = fit.load(path)
        X = {k: Quantity(held[k], ("sample", "z")) for k in GSCOND_KEYS
             if k.endswith("_input")}
        pred = loaded.predict(X)
        ratios = {}
        for v in gscond.EMULATED:
            truth = held[f"{v}_after_gscond"].astype(np.float64)
            err = np.abs(np.asarray(pred[v].data) - truth).mean()
            base = np.abs(held[f"{v}_input"] - truth).mean()
            ratios[v] = err / base
        say(f"C48x63 emulator on the held-out step: mean error / no-change "
            f"baseline {', '.join(f'{k} {r:.4f}' for k, r in ratios.items())}")
        if not ratios["specific_humidity"] < 1.0:
            raise AssertionError(f"emulator: {ratios}")
        tl, cloud = run(emulation.get_hooks(emulation.EmulationConfig(
            gscond=emulation.ModelConfig(path=path))), EMULATED_STEPS,
            "C48x63 emulated")
    say(f"C48x63 emulated: cloud water after each apply_physics >= "
        f"{[f'{c:.3e}' for c in cloud]} (bound {CLOUD_BOUND})")
    if not min(cloud) >= CLOUD_BOUND:
        raise AssertionError(f"emulated: cloud water {min(cloud)}")
    return tl.timer.launches[-1]


# --- phases 17, 18 and 19 ---------------------------------------------------


SERIES_STEPS = 64  # TimeLoop steps of phase 17: 16 simulated hours
SERIES_TRACED = (60, 61)  # steps of phase 17 traced (replayed, eager)
SERIES = [names.TEMP, names.SPHUM]  # the series' state (T and q)
# the FMR's forcings: the cosine of the solar zenith angle and the
# physics' precipitation rate, which the FMR's state (T and q) does not
# set.  Not the surface temperature: it stays constant in this case (a
# prescribed surface), and a constant field normalises by the scaler's
# 1e-12 floor, where a 1-ulp change is ~1e7 standard deviations
FORCINGS = ["cos_zenith_angle", names.PHYSICS_PRECIP_RATE]
LAUNCHES_SERIES = LAUNCHES_NUDGED  # the nudged case's dycore, six species
FMR_HOLD_STEPS = 8  # series steps the FMR's held trainings unroll
# the reservoir's readout: the card's W_out is held by the ridge objective
# ||S W - Y||^2 + lam ||W||^2 (float64, on the CPU): at most
# OBJECTIVE_RATIO times the objective of the CPU's own float32 W_out, or
# within parity.F32_FACTOR times that objective's own f32 spread (the
# CPU's solves from 1-ulp perturbations of S and Y) where that is larger
OBJECTIVE_RATIO = 1.01
# fit.load of a family's dump on the card against the trained model: the
# same parameters and the same kernels, so the same predictions but for
# the order of a reduction (cuDNN's algorithm choice)
ROUND_TRIP_RTOL = 1e-6
# RESERVOIR_SKILL: the reservoir's prediction of the held-out step must
# beat the training steps' mean (a zero or garbled readout predicts that
# mean or worse).  Its error against persistence is printed, not gated:
# the JAX package's reservoir at its defaults does not beat persistence on
# this case's series either (C12 on the CPU: T 0.92-1.70, q 7.5-15.8 of
# persistence's error, tests/reservoir_skill.py); it predicts the state
# from saturated echo states, not the increment.
CYCLE_DOMAINS = ("free_running", "nudged")  # CycleGAN's A and B


def write_store(path, rows):
    """`rows` (name -> per-step arrays [tile, (z,) y, x]) as a zarr-lite
    store of float32 [time, ...] arrays, one chunk a step."""
    from fv3net_tpu_torch.io.zarr_lite import ZarrLiteStore

    store = ZarrLiteStore(path)
    for v, steps in rows.items():
        arr = np.stack(steps).astype(np.float32)
        dims = (("time", "tile", "z", "y", "x") if arr.ndim == 5
                else ("time", "tile", "y", "x"))
        store.create_array(v, shape=arr.shape, chunks=(1,) + arr.shape[1:],
                           dtype=np.float32, dims=dims)
        store.write_full(v, arr)


def phase_series_run(root):
    """The C48 series (module docstring, 17).  Returns the launches of one
    step and the store's path."""
    from fv3net_tpu_torch.utils.zenith import cos_zenith_angle

    wm, _ = nudged_case.initialize(48, "cuda", root)
    mdl = wm.get_model()
    tl = loop_mod.TimeLoop(wm, derived_state.DerivedModelState(wm),
                           mdl.config.dt_atmos, n_steps=SERIES_STEPS)
    tl.timer = SyncTimer()
    stored = SERIES + [names.TSFC, names.PHYSICS_PRECIP_RATE]
    rows = {v: [] for v in stored + FORCINGS[:1]}
    t0 = time.perf_counter()
    with budgets(mdl) as rec, alternating(traced=SERIES_TRACED):
        for time_, _ in tl:
            for v in stored:
                rows[v].append(np.asarray(tl.state[v].values))
            rows[FORCINGS[0]].append(cos_zenith_angle(
                time_, np.rad2deg(mdl.lon), np.rad2deg(mdl.lat)))
    wall = time.perf_counter() - t0
    check_run("C48x63 series", wm, tl, rec, LAUNCHES_SERIES)
    ab_report("C48x63 series", [tl.timer], ("mainloop", "dynamics",
                                            "physics"))
    path = os.path.join(root, "series.zarr")
    write_store(path, rows)
    moved = {v: float(np.abs(rows[v][-1] - rows[v][0]).max()) for v in rows}
    say(f"C48x63 series: {SERIES_STEPS} steps "
        f"({SERIES_STEPS * DT_ATMOS / 3600:g} simulated hours) in "
        f"{wall:.1f} s (clocks synchronised), the same launches in every "
        f"step; max change of each stored field from the first step to the "
        f"last {moved}")
    if not all(moved[v] > 0.0 for v in SERIES + FORCINGS):
        raise AssertionError(f"series: a field did not change: {moved}")
    return tl.timer.launches[-1], path


class Capture:
    """Replaces ``module.<name>`` with a wrapper that times each call
    between two synchronisations (`ms`) and keeps its arguments and
    result (`calls`)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls, self.ms = module, name, [], []

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def wrapped(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.real(*args)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            self.calls.append((args, out))
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def mapper_cfg(function, kwargs, variables, steps=None):
    """A batches_from_mapper data config (one batch a step)."""
    kw = {"mapper_function": function, "mapper_kwargs": kwargs,
          "variable_names": list(variables)}
    if steps is not None:
        kw["timesteps"] = list(steps)
    return {"function": "batches_from_mapper", "kwargs": kw}


def train_cli(root, name, model_type, inputs, outputs, data_cfg,
              hyperparameters=None):
    """The train CLI (fit.train.main) on JSON config files, the family's
    default hyperparameters but for `hyperparameters`, and no --device
    (the card): returns the trained model (kept as the CLI dumps it), its
    directory, the TrainClock of its loops and the CLI's wall seconds."""
    from fv3net_tpu_torch.fit import train as fit_train

    cfgs = {"training": {"model_type": model_type,
                         "hyperparameters": dict(hyperparameters or {}),
                         "input_variables": list(inputs),
                         "output_variables": list(outputs)},
            "data": data_cfg}
    paths = {}
    for kind, cfg in cfgs.items():
        paths[kind] = os.path.join(root, f"{name}_{kind}.yml")
        with open(paths[kind], "w") as f:
            json.dump(cfg, f)  # JSON is YAML
    model_dir = os.path.join(root, f"{name}_model")
    trained, real_dump = [], fit_train.dump
    fit_train.dump = lambda model, path: (trained.append(model),
                                          real_dump(model, path))
    try:
        t0 = time.perf_counter()
        with TrainClock() as clock:
            fit_train.main([paths["training"], paths["data"], model_dir])
        wall = time.perf_counter() - t0
    finally:
        fit_train.dump = real_dump
    return trained[0], model_dir, clock, wall


def hold_f32(tag, got, runs, ref, ref_name="CPU"):
    """`got` (the card's) against `ref` (the CPU's f32, or a float64
    reference: `ref_name`) by parity.f32_rule, the spread from the CPU's
    f32 `runs` (from 1-ulp perturbations of the inputs), name by name."""
    as_t = lambda d: {  # noqa: E731
        k: v.detach().cpu() if isinstance(v, torch.Tensor)
        else torch.as_tensor(np.asarray(v)) for k, v in d.items()}
    held = parity.f32_rule(as_t(got), [as_t(r) for r in runs], as_t(ref))
    say(f"{tag} (card - {ref_name}, bound, max|{ref_name}|): " + ", ".join(
        f"{k} {e:.3e} {b:.3e} {s:.3e}" for k, (e, b, s, _, _) in held.items()))
    for k, (err, bnd, _, errs, finite) in held.items():
        if not (finite and err <= bnd):
            raise AssertionError(f"{tag} {k}: {err:.3e} > {bnd:.3e} ({errs})")


def model_devices(model):
    if hasattr(model, "W_out"):
        return {model.W_out.device.type, model.reservoir.W_in.device.type}
    modules = ((model.gen_ab, model.gen_ba) if hasattr(model, "gen_ab")
               else (model.module,))
    return {p.device.type for m in modules for p in m.parameters()}


def check_dump(tag, trained, model_dir, predict, X, perturb):
    """A family's dump: fit.load with no device puts it on the card and
    predicts what the trained model predicted (ROUND_TRIP_RTOL); the CPU
    port's fit.load of it predicts the same by the f32 rule (its f32
    predictions from `X` and from 1-ulp perturbations, `perturb(X,
    seed)`).  `predict(model, X)`: name -> host array."""
    from fv3net_tpu_torch import fit

    loaded = fit.load(model_dir)
    if model_devices(loaded) != {"cuda"}:
        raise AssertionError(f"{tag}: fit.load put the model on "
                             f"{model_devices(loaded)}")
    got, want = predict(loaded, X), predict(trained, X)
    worst = max(float(np.abs(got[k] - want[k]).max()
                      / max(np.abs(want[k]).max(), 1e-300)) for k in want)
    say(f"{tag}: fit.load of the dump on the card predicts the trained "
        f"model's prediction to {worst:.3e} of its magnitude (bound "
        f"{ROUND_TRIP_RTOL})")
    if not worst <= ROUND_TRIP_RTOL:
        raise AssertionError(f"{tag} round trip: {worst}")
    cpu = fit.load(model_dir, "cpu")
    hold_f32(f"{tag}: the card's dump in the CPU port", got,
             [predict(cpu, perturb(X, s)) for s in range(parity.SPREAD_RUNS)],
             predict(cpu, X))


def perturb_states(states, seed):
    """A list of states (name -> Quantity) with every value moved by one
    f32 ulp (parity.perturb_ulp, a seed a state)."""
    return [parity.perturb_ulp(st, seed * 1000 + t)
            for t, st in enumerate(states)]


def train_reservoir(root, series_path):
    """The reservoir on the series (module docstring, 18)."""
    from fv3net_tpu_torch import data
    from fv3net_tpu_torch.fit import reservoir as rsv

    mapper = data.open_zarr(series_path, SERIES)
    keys = sorted(mapper.keys())
    cfg = mapper_cfg("open_zarr", {"path": series_path}, SERIES, keys[:-1])
    with Capture(rsv, "reservoir_states") as scan, \
            Capture(rsv, "ridge_fit") as ridge:
        trained, model_dir, _, wall = train_cli(
            root, "reservoir", "reservoir", SERIES, SERIES, cfg)
    hp = trained.hp
    (res, Un), states = scan.calls[0]
    (S, Y, lam), W = ridge.calls[0]
    size = sum(t.numel() * 4 for t in (res.W_in, res.W_res, W)) / 1e9
    say(f"C48 reservoir (train CLI, ReservoirHyperparameters' defaults: "
        f"state {hp.state_size}, layout {tuple(hp.subdomain_layout)}, "
        f"overlap {hp.overlap}, quadratic {hp.quadratic_features}, burn-in "
        f"{hp.burn_in}; {len(keys) - 1} steps, the last held out): W_in "
        f"{tuple(res.W_in.shape)}, W_out {tuple(W.shape)} ({size:.3f} GB "
        f"with W_res), readout {tuple(S.shape)}; scan ms {scan.ms[0]:.3f} "
        f"({Un.shape[0]} steps of {tuple(Un.shape[1:])}), ridge ms "
        f"{ridge.ms[0]:.3f}; whole CLI {wall:.1f} s")
    if not S.shape[0] > S.shape[1]:
        raise AssertionError(f"reservoir: {S.shape[0]} rows for "
                             f"{S.shape[1]} features")
    # the scan as the card runs it (one replayed graph a call, the JAX
    # package's lax.scan) against two eager scans, each way's ms
    hold_unit("C48 reservoir scan", rsv._scan, Un, res.W_in, res.W_res,
              float(hp.leakage))
    # the scan's states by the f32 rule, from the same matrices and inputs:
    # as close to the float64 scan as the CPU's f32 scans of the inputs
    # and of their 1-ulp perturbations are (each step sums 85,176
    # products, in another order on the card)
    res_cpu, res64 = (rsv.Reservoir.from_arrays(
        hp, res.W_res.cpu().to(dt), res.W_in.cpu().to(dt), "cpu")
        for dt in (torch.float32, torch.float64))
    u = Un.cpu().numpy()
    hold_f32("C48 reservoir scan states (against float64, the CPU's f32 "
             "scans the spread)", {"states": states},
             [{"states": rsv.reservoir_states(res_cpu, torch.as_tensor(x))}
              for x in [u] + [parity.perturb_ulp({"u": u}, s)["u"]
                              for s in range(parity.SPREAD_RUNS)]],
             {"states": rsv.reservoir_states(
                 res64, torch.as_tensor(u, dtype=torch.float64))}, "f64")
    # W_out by the ridge objective, in float64 on the CPU
    S32, Y32 = S.cpu(), Y.cpu()
    S64, Y64 = S32.double(), Y32.double()

    def objective(w):
        w = w.cpu().double()
        return float(((S64 @ w - Y64) ** 2).sum() + lam * (w ** 2).sum())

    obj_card, obj_cpu = objective(W), objective(rsv.ridge_fit(S32, Y32, lam))
    spread = max(abs(objective(rsv.ridge_fit(
        torch.as_tensor(p["S"]), torch.as_tensor(p["Y"]), lam)) - obj_cpu)
        for p in (parity.perturb_ulp({"S": S32.numpy(), "Y": Y32.numpy()}, s)
                  for s in range(parity.SPREAD_RUNS)))
    bound = max(OBJECTIVE_RATIO * obj_cpu,
                obj_cpu + parity.F32_FACTOR * spread)
    which = ("1.01 x the CPU's" if bound == OBJECTIVE_RATIO * obj_cpu
             else "the objective's f32 spread")
    say(f"C48 reservoir W_out: ridge objective (float64) of the card's "
        f"{obj_card:.9e}, of the CPU's f32 solution {obj_cpu:.9e} (ratio "
        f"{obj_card / obj_cpu:.9f}); f32 spread {spread:.3e}; bound "
        f"{bound:.9e} ({which})")
    if not obj_card <= bound:
        raise AssertionError(f"reservoir objective {obj_card} > {bound}")
    # after synchronize: the held-out step against persistence; the dump
    series = [mapper[k] for k in keys]

    def predict_last(model, sts):
        model.synchronize(sts[:-2])
        return {k: np.asarray(q.values) for k, q in
                model.predict(sts[-2]).items()}

    t0 = time.perf_counter()
    got = predict_last(trained, series)
    sync_s = time.perf_counter() - t0
    ratios = {}
    for v in SERIES:
        truth = np.asarray(series[-1][v].values, np.float64)
        err = np.abs(got[v] - truth).mean()
        ratios[v] = tuple(err / np.abs(base - truth).mean() for base in (
            np.asarray(series[-2][v].values),
            np.mean([np.asarray(st[v].values) for st in series[:-1]], 0)))
    say(f"C48 reservoir on the held-out step (synchronised on "
        f"{len(series) - 2} steps in {sync_s:.2f} s): mean error / "
        f"persistence's, / the training steps' mean's: " + ", ".join(
            f"{k} {p:.4f}, {c:.4f}" for k, (p, c) in ratios.items()))
    # the skill gate (RESERVOIR_SKILL): below the climatology's error
    if not all(c < 1.0 for _, c in ratios.values()):
        raise AssertionError(f"reservoir: no skill over climatology {ratios}")
    check_dump("C48 reservoir", trained, model_dir, predict_last, series,
               perturb_states)


def fmr_state(arrays, t):
    from fv3net_tpu_torch.util.quantity import Quantity

    return {k: Quantity(v[t], ("tile", "z", "y", "x") if v.ndim == 5
                        else ("tile", "y", "x")) for k, v in arrays.items()}


def train_fmr_held(arrays, device, steps):
    from fv3net_tpu_torch import fit

    return fit.train_fmr_model(
        fit.FMRHyperparameters(epochs=steps),
        [fmr_state(arrays, t) for t in range(FMR_HOLD_STEPS)],
        input_variables=FORCINGS, output_variables=SERIES, device=device)


def cube_states(arrays, cubes):
    from fv3net_tpu_torch.util.quantity import Quantity

    return [{k: Quantity(v[c], ("tile", "z", "y", "x"))
             for k, v in arrays.items()} for c in cubes]


def outputs_of(model, X):
    return {k: np.asarray(q.values) for k, q in model.predict(X).items()}


def train_graph_held(arch):
    def train(arrays, device, steps):
        from fv3net_tpu_torch import fit

        # one step: one cube; ten: two cubes, five epochs
        ncubes = 1 if steps == 1 else 2
        return fit.train_graph_model(
            fit.GraphHyperparameters(architecture=arch,
                                     epochs=steps // ncubes),
            cube_states(arrays, range(ncubes)),
            input_variables=TRAIN_VARIABLES[0],
            output_variables=TRAIN_VARIABLES[1], device=device)
    return train


def train_autoencoder_held(arrays, device, steps):
    from fv3net_tpu_torch import fit

    return fit.train_autoencoder(
        fit.AutoencoderHyperparameters(epochs=steps),
        cube_states(arrays, [0]), input_variables=SERIES, device=device)


def cycle_names(domain):
    return [f"{v}_{domain}" for v in SERIES]


def train_cyclegan_held(arrays, device, steps):
    from fv3net_tpu_torch import fit

    return fit.train_cyclegan(
        fit.CycleGANHyperparameters(epochs=steps), cube_states(arrays, [0]),
        input_variables=cycle_names(CYCLE_DOMAINS[0]),
        output_variables=cycle_names(CYCLE_DOMAINS[1]), device=device)


def family_ab(tag, model_type, data_cfg, inputs, outputs, samples, unit,
              hyperparameters=None):
    """The train CLI's training of a family (its training function on the
    CLI's batches, read once) eager and replayed in turns (ab_training)."""
    from fv3net_tpu_torch import data
    from fv3net_tpu_torch.fit import _shared

    batches = list(data.open_batches_from_config(data_cfg))
    train = _shared.get_training_function(model_type)
    hp = _shared.get_hyperparameter_class(model_type)(
        **(hyperparameters or {}))
    return ab_training(tag, lambda: train(
        hp, batches, input_variables=inputs, output_variables=outputs,
        device="cuda"), samples, unit)


def report_family(tag, model_hp, clock, wall, samples, unit, falls=True):
    losses = clock.loss
    say(f"{tag} (train CLI, defaults {model_hp}): {clock.report(samples)} "
        f"(samples: {unit}); whole CLI {wall:.1f} s; loss first "
        f"{losses[0]:.6e}, last {losses[-1]:.6e}")
    if falls and not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: the loss did not fall: {losses}")


def phase_families(root, series_path):
    """The rest of fv3fit's families trained through the train CLI on the
    card at C48x63, each held against the CPU (module docstring, 18).
    Returns the graph (mpg) model's directory."""
    from fv3net_tpu_torch import data

    train_reservoir(root, series_path)
    cols = 6 * 48 * 48
    series = data.open_zarr(series_path, SERIES + FORCINGS)
    keys = sorted(series.keys())

    def stack(mapper, ks, vs):
        return {v: np.stack([np.asarray(mapper[k][v].values) for k in ks])
                for v in vs}

    # fmr: the forcings in, the state it replaces out, on the series
    model, path, clock, wall = train_cli(
        root, "fmr", "fmr", FORCINGS, SERIES,
        mapper_cfg("open_zarr", {"path": series_path}, SERIES + FORCINGS))
    hp = model.hp
    report_family("C48 fmr", dataclasses.asdict(hp), clock, wall,
                  hp.epochs * (len(keys) - 1) * cols,
                  f"column steps, {len(keys) - 1} unrolled steps of {cols} "
                  f"columns an epoch")
    held = stack(series, keys[:FMR_HOLD_STEPS], SERIES + FORCINGS)
    fixed = fmr_state(stack(series, [keys[FMR_HOLD_STEPS]],
                            SERIES + FORCINGS), 0)
    family_ab("C48 fmr training", "fmr", mapper_cfg(
        "open_zarr", {"path": series_path}, SERIES + FORCINGS), FORCINGS,
        SERIES, AB_EPOCHS * (len(keys) - 1) * cols,
        f"column steps, {AB_EPOCHS} epochs", {"epochs": AB_EPOCHS})
    hold_training("C48 fmr training", train_fmr_held, held, None,
                  lambda m: outputs_of(m, fixed), hp.learning_rate)
    check_dump("C48 fmr", model, path, outputs_of, fixed, parity.perturb_ulp)

    # graph (mpg and unet) on the nudged run's stores, as phase 14
    out = os.path.join(root, "out")
    nudged = data.open_nudge_to_fine(out)
    nkeys = sorted(nudged.keys())
    cubes = stack(nudged, nkeys, sum(TRAIN_VARIABLES, []))
    fixed = {k: q for k, q in cube_states(cubes, [len(nkeys) - 1])[0].items()
             if k in TRAIN_VARIABLES[0]}
    graph_dir = None
    for arch in ("mpg", "unet"):
        model, path, clock, wall = train_cli(
            root, f"graph_{arch}", "graph", *TRAIN_VARIABLES,
            mapper_cfg("open_nudge_to_fine", {"url": out},
                       sum(TRAIN_VARIABLES, [])), {"architecture": arch})
        hp = model.hp
        report_family(f"C48 graph {arch}", dataclasses.asdict(hp), clock,
                      wall, hp.epochs * len(nkeys) * cols,
                      "columns, one cube a step")
        family_ab(f"C48 graph {arch} training", "graph", mapper_cfg(
            "open_nudge_to_fine", {"url": out}, sum(TRAIN_VARIABLES, [])),
            *TRAIN_VARIABLES, hp.epochs * len(nkeys) * cols, "columns",
            {"architecture": arch})
        hold_training(f"C48 graph {arch} training", train_graph_held(arch),
                      cubes, None, lambda m: outputs_of(m, fixed),
                      hp.learning_rate)
        check_dump(f"C48 graph {arch}", model, path, outputs_of, fixed,
                   parity.perturb_ulp)
        graph_dir = graph_dir or path

    # the autoencoder on the nudged run's T and q
    model, path, clock, wall = train_cli(
        root, "autoencoder", "autoencoder", SERIES, SERIES,
        mapper_cfg("open_nudge_to_fine", {"url": out}, SERIES))
    report_family("C48 autoencoder", {
        k: getattr(model.module, k) for k in ("filters", "depth", "latent")},
        clock, wall, clock.steps * len(nkeys) * cols,
        "columns, every cube each step")
    family_ab("C48 autoencoder training", "autoencoder", mapper_cfg(
        "open_nudge_to_fine", {"url": out}, SERIES), SERIES, SERIES,
        clock.steps * len(nkeys) * cols, "columns")
    fixed = {k: q for k, q in fixed.items() if k in SERIES}
    hold_training("C48 autoencoder training", train_autoencoder_held,
                  stack(nudged, nkeys[:1], SERIES), None,
                  lambda m: outputs_of(m, fixed), 1e-3)
    check_dump("C48 autoencoder", model, path, outputs_of, fixed,
               parity.perturb_ulp)

    # CycleGAN: the series' first steps (A, free running) against the
    # nudged run's at the same times (B)
    pairs = {f"{v}_{CYCLE_DOMAINS[0]}": [np.asarray(series[k][v].values)
                                          for k in keys[:len(nkeys)]]
             for v in SERIES}
    pairs.update({f"{v}_{CYCLE_DOMAINS[1]}": [
        np.asarray(nudged[k][v].values) for k in nkeys] for v in SERIES})
    cycle_path = os.path.join(root, "cyclegan.zarr")
    write_store(cycle_path, pairs)
    a_names, b_names = (cycle_names(d) for d in CYCLE_DOMAINS)
    model, path, clock, wall = train_cli(
        root, "cyclegan", "cyclegan", a_names, b_names,
        mapper_cfg("open_zarr", {"path": cycle_path}, a_names + b_names))
    rounds = clock.steps // 2
    report_family("C48 cyclegan", {
        k: getattr(model.gen_ab, k) for k in ("filters", "n_res")}, clock,
        wall, rounds * 2 * len(nkeys) * cols,
        "columns of both domains, a generator and a discriminator step a "
        f"round: ms per round {2e3 * clock.seconds / clock.steps:.4f}",
        falls=False)
    family_ab("C48 cyclegan training", "cyclegan", mapper_cfg(
        "open_zarr", {"path": cycle_path}, a_names + b_names), a_names,
        b_names, AB_EPOCHS * 2 * len(nkeys) * cols,
        f"columns of both domains, {AB_EPOCHS} epochs",
        {"epochs": AB_EPOCHS})
    arrays = {k: np.stack(v) for k, v in pairs.items()}
    fixed = cube_states({k: arrays[k] for k in a_names}, [len(nkeys) - 1])[0]
    hold_training("C48 cyclegan training", train_cyclegan_held, arrays, None,
                  lambda m: outputs_of(m, fixed), 2e-4, per_step=2)
    check_dump("C48 cyclegan", model, path, outputs_of, fixed,
               parity.perturb_ulp)
    return graph_dir


def offline_numbers(report):
    """The scalar metrics and the per-level profiles an offline report
    wrote: name -> value or array."""
    with open(os.path.join(report, "scalar_metrics.json")) as f:
        out = {k: np.float64(v) for k, v in json.load(f).items()}
    with np.load(os.path.join(report, "offline_diagnostics.npz")) as d:
        out.update({k: d[k] for k in d.files if k.endswith("_profile")})
    return out


OFFLINE_AB = 3  # predict_over_mapper calls of each side (phase 19)


def phase_offline(root, dense_dir, graph_dir):
    """The offline evaluation (module docstring, 19)."""
    from fv3net_tpu_torch import data, fit
    from fv3net_tpu_torch.diagnostics import cli as diag_cli, offline

    out = os.path.join(root, "out")
    spec = os.path.join(root, "offline.yml")
    with open(spec, "w") as f:
        json.dump({"mapper_function": "open_nudge_to_fine",
                   "mapper_kwargs": {"url": out}}, f)
    mapper = data.open_nudge_to_fine(out)
    g = CubedSphereGrid.make(48, halo=3)
    grid = {k: np.asarray(getattr(g, k)[g.interior])
            for k in ("area", "lat", "lon")}
    for tag, model_dir in (("dense", dense_dir), ("graph mpg", graph_dir)):
        report = os.path.join(root, f"offline_{tag.replace(' ', '_')}")
        with Capture(offline, "column_jacobian") as jac, \
                Capture(offline, "predict_over_mapper") as pred:
            t0 = time.perf_counter()
            if diag_cli.main(["offline", model_dir, spec, "-o", report]):
                raise AssertionError(f"offline {tag}: nonzero exit")
            wall = time.perf_counter() - t0
        if model_devices(pred.calls[0][0][0]) != {"cuda"}:
            raise AssertionError(f"offline {tag}: the model is not on the "
                                 f"card")
        # the predictions again, eager beside replayed (the CLI's call
        # captured the model's apply)
        args = pred.calls[0][0]
        ab_calls(f"C48 offline {tag} predict_over_mapper",
                 eagerly(lambda: offline.predict_over_mapper(*args)),
                 lambda: offline.predict_over_mapper(*args), OFFLINE_AB)
        apply = args[0]._apply
        say(f"C48 offline {tag}: {apply.captures()} capture(s) of the "
            f"model's {apply.name} (one a batch shape), "
            f"{apply.memory() / 2**20:.2f} MiB held")
        files = sorted(os.listdir(report))
        want = {"index.html", "offline_diagnostics.npz",
                "scalar_metrics.json"} | (
            {"jacobians.npz"} if tag == "dense" else set())
        if set(files) != want:
            raise AssertionError(f"offline {tag}: files {files}")
        got = offline_numbers(report)
        say(f"C48 offline {tag} (diagnostics.cli offline on the card, "
            f"{len(mapper)} times of the nudged stores, the model on the "
            f"card): {wall:.2f} s, predictions {pred.ms[0] / 1e3:.2f} s and "
            f"the column Jacobian {sum(jac.ms) / 1e3:.2f} s of it "
            f"({len(jac.calls)} call); files {files}; metrics " + ", ".join(
                f"{k} {v:.4e}" for k, v in got.items() if np.ndim(v) == 0))
        inputs = fit.load(model_dir, "cpu").input_variables

        def cpu_numbers(m, name):
            path = os.path.join(root, f"offline_cpu_{name}")
            offline.evaluate(model_dir, m, grid, path, jacobian=False,
                             device="cpu")
            return offline_numbers(path)

        runs = [cpu_numbers({t: dict(st, **parity.perturb_ulp(
            {k: st[k] for k in inputs}, 1000 * s + i))
            for i, (t, st) in enumerate(sorted(mapper.items()))}, s)
            for s in range(parity.SPREAD_RUNS)]
        hold_f32(f"C48 offline {tag} metrics and profiles", got, runs,
                 cpu_numbers(mapper, "ref"))
        if tag == "dense":
            card_jac = jac.calls[0][1]
            cpu = fit.load(model_dir, "cpu")
            sample = mapper[sorted(mapper.keys())[0]]
            hold_f32("C48 offline dense column Jacobian (against float64, "
                     "the CPU's f32 the spread)", card_jac,
                     [offline.column_jacobian(cpu, sample)],
                     offline.column_jacobian(F64Dense(cpu), sample), "f64")
        elif jac.calls and jac.calls[0][1]:
            raise AssertionError("offline graph: a column Jacobian")
    report_units("C48 offline (and the earlier phases' models)")


# --- phase 20 ---------------------------------------------------------------

# the groups that interpolate to pressure levels (compute.py)
PRESSURE_LEVEL_GROUPS = ("pressure_level_zonal_time_mean",
                         "pressure_level_zonal_bias",
                         "300_700_zonal_mean_value")


class InterpClock:
    """Wall time of each call of utils.interpolate's
    interpolate_to_pressure_levels (which returns a host array, so each
    call ends synchronised), patched in while the clock is used."""

    def __init__(self):
        from fv3net_tpu_torch.utils import interpolate

        self.module, self.fn, self.seconds = (
            interpolate, interpolate.interpolate_to_pressure_levels, [])

    def __enter__(self):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.fn(*args, **kwargs)
            self.seconds.append(time.perf_counter() - t0)
            return out

        self.module.interpolate_to_pressure_levels = timed
        return self

    def __exit__(self, *exc):
        self.module.interpolate_to_pressure_levels = self.fn


def same_arrays(tag, got, want):
    """Equal dicts of host arrays (NaN for NaN)."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{tag}: keys differ")
    for k in want:
        if not np.array_equal(np.asarray(got[k]), np.asarray(want[k]),
                              equal_nan=True):
            raise AssertionError(f"{tag}: {k} differs")


def phase_diagnostics(root):
    """The prognostic-run diagnostics of the C48 runs (module docstring,
    20)."""
    import io

    from fv3net_tpu_torch.diagnostics import cli as dcli
    from fv3net_tpu_torch.diagnostics.compute import (
        compute_diagnostics, load_run)

    run, ver = (os.path.join(root, *DIAG_STORES[k])
                for k in ("ML-corrected", "nudged"))
    out = os.path.join(root, "diags")
    dt_hours = DT_ATMOS / 3600.0
    walls = {}
    for tag, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        t0 = time.perf_counter()
        dcli.main(["compute", run, "-o", os.path.join(out, tag),
                   "--verification", ver, "--dt-hours", str(dt_hours)]
                  + extra)
        walls[f"compute {tag}"] = time.perf_counter() - t0
    saved = [np.load(os.path.join(out, t, "diags.npz")) for t in ("card",
                                                                 "cpu")]
    same_arrays("diagnostics compute: card vs --device cpu",
                {k: saved[0][k] for k in saved[0].files},
                {k: saved[1][k] for k in saved[1].files})
    metrics = [json.load(open(os.path.join(out, t, "metrics.json")))
               for t in ("card", "cpu")]
    if metrics[0] != metrics[1] or not metrics[0]:
        raise AssertionError("diagnostics compute: metrics differ")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dcli.main(["metrics", os.path.join(out, "card", "diags.npz")])
    if json.loads(buf.getvalue()) != metrics[0]:
        raise AssertionError("diagnostics metrics: not metrics.json")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        dcli.main(["report", run, "-o", os.path.join(out, "card"),
                   "--dt-hours", str(dt_hours)])
    walls["report card"] = time.perf_counter() - t0
    page = open(os.path.join(out, "card", "index.html")).read()
    if "Metrics" not in page or "<svg" not in page:
        raise AssertionError("diagnostics report: no metrics or series")
    say(f"C48x63 diagnostics (CLI): compute on the card and with --device "
        f"cpu: {len(saved[0].files)} diagnostics and {len(metrics[0])} "
        f"metrics, equal; metrics re-emitted; report written "
        f"({len(page)} bytes)")

    # the pressure-level groups: the grid with the run's delp
    pred, verif = load_run(run), load_run(ver)
    for r in (pred, verif):
        r.pop("time", None)
    g = CubedSphereGrid.make(pred[names.TEMP].shape[-1], halo=3)
    grid = {"area": np.asarray(g.area[g.interior]),
            "lat": np.asarray(g.lat[g.interior]),
            "lon": np.asarray(g.lon[g.interior]),
            "delp": pred[names.DELP], "dt_hours": dt_hours}
    with InterpClock() as clock:
        t0 = time.perf_counter()
        card_d, card_m = compute_diagnostics(pred, grid=grid,
                                             verification=verif)
        walls["compute_diagnostics card"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_d, cpu_m = compute_diagnostics(pred, grid=grid, verification=verif,
                                       device="cpu")
    walls["compute_diagnostics cpu"] = time.perf_counter() - t0

    def f64(d):
        return {k: v.astype(np.float64) for k, v in d.items()}

    ref_d, _ = compute_diagnostics(
        f64(pred), grid=dict(grid, delp=pred[names.DELP].astype(np.float64)),
        verification=f64(verif), device="cpu")
    level = [k for k in card_d
             if any(k.endswith("_" + grp) for grp in PRESSURE_LEVEL_GROUPS)]
    if len(level) != 3 * len(PRESSURE_LEVEL_GROUPS):
        raise AssertionError(f"diagnostics: pressure-level keys {level}")
    same_arrays("diagnostics: card vs CPU (host groups)",
                {k: v for k, v in card_d.items() if k not in level},
                {k: v for k, v in cpu_d.items() if k not in level})
    if card_m != cpu_m:
        raise AssertionError("diagnostics: the card's metrics differ")
    for k in level:
        nan = [np.isnan(np.asarray(d[k])) for d in (card_d, cpu_d, ref_d)]
        if not np.array_equal(nan[0], nan[1]):
            raise AssertionError(f"diagnostics {k}: NaN where the CPU's "
                                 f"is not")
        keep = ~(nan[0] | nan[2])
        err, bnd, scale, errs, finite = parity.f32_rule(
            {k: torch.as_tensor(np.asarray(card_d[k])[keep])},
            [{k: torch.as_tensor(np.asarray(cpu_d[k])[keep])}],
            {k: torch.as_tensor(np.asarray(ref_d[k])[keep])})[k]
        say(f"C48x63 diagnostics {k}: card vs f64 {err:.3e} (bound "
            f"{bnd:.3e}, CPU f32 {errs[0]:.3e}, scale {scale:.3e}; "
            f"{int(keep.sum())} values, {int(nan[0].sum())} NaN below the "
            f"surface)")
        if not (finite and err <= bnd):
            raise AssertionError(f"diagnostics {k}: {err} > {bnd}")
    interp_ms = 1e3 * sum(clock.seconds)
    say(f"C48x63 diagnostics wall s: {walls}; compute_diagnostics on the "
        f"card {len(card_d)} diagnostics, {len(clock.seconds)} "
        f"interpolations {interp_ms:.1f} ms of its "
        f"{1e3 * walls['compute_diagnostics card']:.1f} ms (each call "
        f"synchronised), the rest host numpy")

    # log-viewer on the ML-corrected run's logs, single-run on the emulated
    # run's stored gscond
    html = dcli.log_viewer_cmd(os.path.join(root, *DIAG_LOGS),
                               os.path.join(out, "logs"))
    page = open(html).read()
    if "mainloop" not in page or "<svg" not in page:
        raise AssertionError("log-viewer: no timings or series")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dcli.main(["single-run", os.path.join(root, "emulation"), "-o",
                   os.path.join(out, "single")])
    single = json.loads(buf.getvalue())
    if json.load(open(os.path.join(out, "single",
                                   "single_run.json"))) != single:
        raise AssertionError("single-run: single_run.json differs")
    say(f"C48x63 log-viewer: {html} ({len(page)} bytes); single-run on "
        f"the emulated run's storage: {single}")


# --- phase 21 ---------------------------------------------------------------

COARSE_N, COARSE_FACTOR = 384, 8  # C384 -> C48
COARSE_TILES, COARSE_CELLS = 2, 6  # the window held against the CPU
REMAP_WINDOW = 96  # fine columns a side of tile 0: K5 against plain
# K5 on the coarsening path: the pressure method remaps the five fields of
# delp's shape (T, q, cloud water, w, delz), the blended method remaps
# them again, the budget its five (omega, T, q and the two moments)
LAUNCHES_COARSENING = dict({k: 0 for k in WRAPPERS}, ppm_remap=15)
COARSE_MASS_BOUND = 1e-5  # column mass across the remap, flat blocks
CATEGORICAL = ("slmsk", "vtype", "stype", "srflag", "slope")
T0_COARSE = 288.0  # ps = 1e5 exp(-phis / (Rd T0))


def coarsening_state(device, n=COARSE_N, factor=COARSE_FACTOR, seed=0):
    """A seeded C<n> x 63 restart state in float32 on `device`, after
    restart_fields' recipe (runtime/nudged_case.py) but for the surface:
    per coarse block, flat at sea level (blending weight 1), or a base
    elevation of 0-1500 m with white noise of amplitude 170-340 m (ps
    +-20-40 hPa inside the block, weight strictly between 0 and 1) or a
    two-valued terrain +-250-340 m (weight 0).  Returns (state, area,
    phis, omega, sfc)."""
    from fv3net_tpu_torch.dycore.hydro import hybrid_coefficients
    from fv3net_tpu_torch.physics.gfs import qsat
    from fv3net_tpu_torch.constants import RDGAS, ZVIR

    gen = torch.Generator(device=device).manual_seed(seed)
    f64 = dict(device=device, dtype=torch.float64, generator=gen)

    def up(c):
        return c.repeat_interleave(factor, -2).repeat_interleave(factor, -1)

    nc = n // factor
    kind = up(torch.randint(0, 3, (6, nc, nc), device=device,
                            generator=gen))
    base = up(1500.0 * torch.rand(6, nc, nc, **f64))
    amp = up(170.0 + 170.0 * torch.rand(6, nc, nc, **f64))
    noise = 2.0 * torch.rand(6, n, n, **f64) - 1.0
    h = torch.where(kind == 0, torch.zeros_like(base),
                    base + amp * torch.where(kind == 1, noise,
                                             torch.sign(noise)))
    phis = GRAV * h
    ps = 1.0e5 * torch.exp(-phis / (RDGAS * T0_COARSE))
    ak, bk = (c.to(device, torch.float64)
              for c in hybrid_coefficients(NZ, PTOP))
    pe = ak[None, :, None, None] + bk[None, :, None, None] * ps[:, None]
    delp = pe[:, 1:] - pe[:, :-1]
    p = 0.5 * (pe[:, 1:] + pe[:, :-1])
    temp = torch.clamp(300.0 * (p / 1.0e5) ** 0.19, min=210.0)
    temp = temp + torch.randn(6, NZ, n, n, **f64)
    rh = 0.5 + 0.6 * torch.rand(6, 1, n, n, **f64)
    q = rh * (p / p[:, -1:]) ** 3 * qsat(temp, p)
    delz = -(RDGAS / GRAV) * temp * (1.0 + ZVIR * q) * torch.log(
        pe[:, 1:] / pe[:, :-1])
    del pe
    f32 = dict(device=device, dtype=torch.float32, generator=gen)
    state = {
        names.DELP: delp, names.TEMP: temp, names.SPHUM: q,
        names.CLOUD: 1e-4 * torch.rand(6, NZ, n, n, **f64) * (temp > 250.0),
        "vertical_wind": 0.1 * torch.randn(6, NZ, n, n, **f64),
        "vertical_thickness_of_atmospheric_layer": delz,
        "surface_geopotential": phis,
    }
    state = {k: v.float() for k, v in state.items()}
    del delp, temp, q, delz, p
    state[names.X_WIND] = 5.0 * torch.randn(6, NZ, n + 1, n, **f32)
    state[names.Y_WIND] = 5.0 * torch.randn(6, NZ, n, n + 1, **f32)
    g = CubedSphereGrid.make(n, halo=0)
    area = torch.as_tensor(g.area.astype(np.float32), device=device)
    omega = 0.5 * torch.randn(6, NZ, n, n, **f32)
    s = (6, n, n)

    def pick(values):
        v = torch.tensor(values, device=device, dtype=torch.float32)
        return v[torch.randint(0, len(values), s, device=device,
                               generator=gen)]

    def r(lo=0.0, hi=1.0, shape=s):
        return lo + (hi - lo) * torch.rand(shape, **f32)

    sfc = {
        "slmsk": pick([0.0, 1.0, 2.0]), "vtype": pick([1.0, 7.0, 15.0]),
        "stype": pick([2.0, 5.0, 9.0]), "vfrac": r() * (r() > 0.3),
        "sncovr": r(), "fice": r(), "tsea": r(270.0, 280.0),
        "tg3": r(270.0, 280.0), "canopy": r(), "zorl": r(),
        "smc": r(shape=(6, 4, n, n)), "stc": r(280.0, 281.0, (6, 4, n, n)),
        "slc": r(), "srflag": pick([0.0, 1.0]), "slope": pick([1.0, 2.0,
                                                               3.0]),
        "sheleg": r(), "hice": r(), "shdmin": r(0.0, 0.02),
        "shdmax": r(), "snoalb": r(), "tisfc": r(260.0, 270.0),
        "alvsf": r(), "t2m": r(280.0, 281.0), "uustar": r(),
    }
    return state, area, state["surface_geopotential"], omega, sfc


class EventClock:
    """CUDA-event ms of named blocks (each ends synchronised)."""

    def __init__(self):
        self.ms = {}

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        yield
        t1.record()
        torch.cuda.synchronize()
        self.ms[name] = t0.elapsed_time(t1)


def coarsen_all(state, area, phis, omega, sfc, clock):
    """The coarsening path (module docstring, 21) on the tensors' device:
    every method's outputs, each method timed by `clock`."""
    from fv3net_tpu_torch.utils import coarsen_restarts as cr
    from fv3net_tpu_torch.utils import fine_res_budget as fb
    from fv3net_tpu_torch.utils.coarsen import weighted_block_average

    f = COARSE_FACTOR
    out = {}
    with clock("sigma"):
        out["sigma"] = cr.coarsen_restarts_on_sigma(state, area, f)
    with clock("pressure"):
        out["pressure"] = cr.coarsen_restarts_on_pressure(state, area, f)
    with clock("blended"):
        out["blended"] = cr.coarsen_restarts_via_blended_method(
            state, area, f, phis=phis)
        out["blending_weight"] = {
            "w": cr.blending_weight(phis, area, f)}
    with clock("sfc_data_complex"):
        out["sfc"] = cr.coarsen_sfc_data_complex(sfc, area, f)
    fine = {k: state[k] for k in (names.DELP, names.TEMP, names.SPHUM)}
    fine["omega"] = omega
    delp_c = weighted_block_average(state[names.DELP], area[:, None], f)
    with clock("budget"):
        out["budget"] = fb.compute_budget_ingredients(
            fine, delp_c, area, f)
    return out


def window(x, cells, tiles=COARSE_TILES):
    """The first `cells` x `cells` cells of the first `tiles` tiles of x
    [tile, ..., y, x] (a staggered wind with its closing edge)."""
    ny, nx = x.shape[-2:]
    n = min(ny, nx)
    return x[:tiles, ..., : cells + ny - n, : cells + nx - n]


def coarse_window(x):
    """The held window of a coarse output, as a float64 CPU tensor."""
    return window(torch.as_tensor(x), COARSE_CELLS).double().cpu()


def null_clock(name):
    return contextlib.nullcontext()


def phase_coarsening():
    """C384 x 63 -> C48 coarsening on the card (module docstring, 21).
    Returns the launches of the path."""
    from fv3net_tpu_torch.utils import coarsen_restarts as cr
    from fv3net_tpu_torch.utils.coarsen import (
        block_coarsen, block_upsample, weighted_block_average)

    n, f = COARSE_N, COARSE_FACTOR
    t0 = time.perf_counter()
    state, area, phis, omega, sfc = coarsening_state("cuda")
    torch.cuda.synchronize()
    ps = state[names.DELP].double().sum(1) + PTOP
    spread = (block_coarsen(ps, f, "max") - block_coarsen(ps, f, "min"))
    say(f"C{n}x63 coarsening state on the card in "
        f"{time.perf_counter() - t0:.1f} s: {len(state)} restart fields, "
        f"{len(sfc)} surface fields; ps spread inside a block "
        f"{float(spread.min()):.1f}-{float(spread.max()):.1f} Pa, flat in "
        f"{int((spread == 0).sum())} of {spread.numel()} blocks")
    clock = EventClock()
    coarsen_all(state, area, phis, omega, sfc, clock)  # warm-up
    reset_counts()
    out = coarsen_all(state, area, phis, omega, sfc, clock)
    torch.cuda.synchronize()
    launches = read_counts()
    check_counts(f"C{n}->C{n // f} coarsening", launches,
                 LAUNCHES_COARSENING)
    say(f"C{n}x63 -> C{n // f}x63 coarsening ms (CUDA events): "
        + ", ".join(f"{k} {v:.2f}" for k, v in clock.ms.items())
        + f"; K5 launches {launches['ppm_remap']}")
    w = out["blending_weight"]["w"]
    counts = [int((w == 1).sum()), int(((w > 0) & (w < 1)).sum()),
              int((w == 0).sum())]
    say(f"C{n} blending weight: 1 in {counts[0]}, strictly between in "
        f"{counts[1]}, 0 in {counts[2]} blocks")
    if not all(counts):
        raise AssertionError(f"blending weight classes {counts}")
    for group in out.values():
        for k, v in group.items():
            if not bool(torch.isfinite(torch.as_tensor(v)).all()):
                raise AssertionError(f"coarsening: non-finite {k}")

    # (a) K5 against the plain remap on a window of the C384 columns, both
    # forms, as the pressure method and the budget call it
    delp = state[names.DELP]
    delp_c = weighted_block_average(delp, area[:, None], f)
    pe1 = cr._interface_pressure(delp, PTOP)
    pe2 = cr._interface_pressure(block_upsample(delp_c, f), PTOP)
    q = state[names.TEMP]
    k5 = ppm_remap_cuda(q, pe1, pe2, 1, 9)
    mappm = remap.remap_levels_mappm(q, pe1, pe2, 1, 9)
    win = np.s_[:1, :, :REMAP_WINDOW, :REMAP_WINDOW]
    qw, p1w, p2w = (t[win].contiguous() for t in (q, pe1, pe2))
    below = p2w[:, -1] - p1w[:, -1]
    errs = [
        check_close(f"C{n} remap window (exact)", k5[win],
                    remap.remap_levels_plain(qw, p1w, p2w, 1, 9),
                    2e-5, 2e-5),
        check_close(f"C{n} remap window (mappm)", mappm[win],
                    remap.ppm_remap(qw.movedim(1, 0), p1w.movedim(1, 0),
                                    p2w.movedim(1, 0), iv=1, kord=9)
                    .movedim(0, 1), 2e-5, 2e-5),
    ]
    ms = cuda_ms(lambda: ppm_remap_cuda(q, pe1, pe2, 1, 9))
    plain_ms = cuda_ms(lambda: remap.remap_levels_plain(qw, p1w, p2w, 1, 9))
    b_ms, b_by = bound([q, pe1, pe2], [k5], OPS_REMAP_LEVEL * q.numel()
                       + OPS_REMAP_TARGET * k5.numel()
                       + OPS_REMAP_PAIR * overlap_pairs(pe1, pe2))
    say(f"C{n} K5 vs plain on tile 0's {REMAP_WINDOW}x{REMAP_WINDOW} "
        f"columns: max err {max(errs):.3e} (exact, mappm); target bottom "
        f"- source bottom {float(below.min()):.1f} to "
        f"{float(below.max()):.1f} Pa; K5 on [6, 63, {n}, {n}] {ms:.4f} ms "
        f"(bound {b_ms:.4f} ms, {b_by}, {b_ms / ms:.1%} of it), plain on "
        f"the window {plain_ms:.4f} ms")
    if not (below.min() < 0 < below.max()):
        raise AssertionError("remap window: no target edge below and above "
                             "the source bottom")

    # (d) column mass across the remap where the block is flat (its
    # block-mean ps equals its own)
    flat = block_upsample(spread == 0, f)
    dp1 = (pe1[:, 1:] - pe1[:, :-1]).double()
    dp2 = (pe2[:, 1:] - pe2[:, :-1]).double()
    m1 = (q.double() * dp1).sum(1)
    rel = [float(((o.double() * dp2).sum(1) / m1 - 1.0).abs()[flat].max())
           for o in (k5, mappm)]
    say(f"C{n} flat blocks ({int(flat.sum())} columns): column mass across "
        f"K5 {rel[0]:.3e} (exact) {rel[1]:.3e} (mappm), bound "
        f"{COARSE_MASS_BOUND}")
    if not max(rel) <= COARSE_MASS_BOUND:
        raise AssertionError(f"coarsening mass {rel}")
    del k5, mappm, pe1, pe2, dp1, dp2, m1

    # (b) every output on a window of whole coarse blocks against the
    # port's float64 run on the CPU of the same fine columns, by the f32
    # spread (parity.f32_rule over the CPU's float32 runs from the inputs
    # and from SPREAD_RUNS 1-ulp perturbations of them, the categorical
    # surface fields kept): the card sums blocks in other orders than the
    # CPU, so one CPU run may round closer to float64 by chance
    def window_inputs(dtype, seed=None):
        def w(x, name=None):
            x = window(x, COARSE_CELLS * f).to("cpu", dtype)
            if seed is None or name in CATEGORICAL:
                return x
            return torch.as_tensor(parity.perturb_ulp(
                {name: x.numpy()}, seed)[name])

        return ({k: w(v, k) for k, v in state.items()}, w(area, "area"),
                w(phis, "phis"), w(omega, "omega"),
                {k: w(v, k) for k, v in sfc.items()})

    runs32 = [coarsen_all(*window_inputs(torch.float32, seed), null_clock)
              for seed in [None] + list(range(parity.SPREAD_RUNS))]
    run64 = coarsen_all(*window_inputs(torch.float64), null_clock)
    held = 0
    for group, outs in out.items():
        got = {k: coarse_window(v) for k, v in outs.items()}
        cpu32 = [{k: coarse_window(v) for k, v in r[group].items()}
                 for r in runs32]
        ref64 = {k: coarse_window(v) for k, v in run64[group].items()}
        worst = (0.0, "")
        for k, (err, bnd, scale, e32, finite) in parity.f32_rule(
                got, cpu32, ref64).items():
            if not (finite and err <= bnd):
                raise AssertionError(f"coarsening {group} {k}: card vs f64 "
                                     f"{err:.3e} > {bnd:.3e} (CPU f32 "
                                     f"{max(e32):.3e}, scale {scale:.3e})")
            worst = max(worst, (err / bnd if bnd else 0.0, k))
            held += 1
        say(f"C{n} {group} window: {len(got)} outputs within the f32 spread "
            f"of the float64 CPU run (at most {worst[0]:.2f} of the bound, "
            f"{worst[1]})")
    for k in CATEGORICAL:
        if not torch.equal(coarse_window(out["sfc"][k]),
                           coarse_window(run64["sfc"][k])):
            raise AssertionError(f"coarsening sfc {k}: not the CPU's modes")
    say(f"C{n} coarsening window ({COARSE_TILES} tiles x {COARSE_CELLS}x"
        f"{COARSE_CELLS} coarse cells): {held} outputs held")
    return launches


# --- phase 22 ---------------------------------------------------------------


def w2_fields(g, u0=None, gh0=2.94e4):
    """Williamson case 2: steady zonal geostrophic flow (alpha = 0) on grid
    g: (depth [6, n, n], u [6, n+1, n], v [6, n, n+1]) as numpy float64,
    the recipe of tests/test_sw.py::w2_fields."""
    from fv3net_tpu_torch.constants import OMEGA, RADIUS

    if u0 is None:
        u0 = 2 * np.pi * RADIUS / (12 * 86400.0)
    h, n = g.halo, g.n

    def h_of_lat(lat):
        return (
            gh0 - (RADIUS * OMEGA * u0 + 0.5 * u0 ** 2) * np.sin(lat) ** 2
        ) / GRAV

    def vel(p):
        # eastward flow u0*cos(lat): V = omega_vec x r with omega = u0/R
        w = np.array([0.0, 0.0, u0])
        return np.cross(np.broadcast_to(w, p.shape), p)

    depth = h_of_lat(g.lat[g.interior])
    cor = g.corners_xyz[:, h : h + n + 1, h : h + n + 1]

    def edge_wind(a, b):
        mid = a + b
        mid = mid / np.linalg.norm(mid, axis=-1, keepdims=True)
        t = b - a
        t = t - np.sum(t * mid, axis=-1, keepdims=True) * mid
        t = t / np.linalg.norm(t, axis=-1, keepdims=True)
        return np.sum(vel(mid) * t, axis=-1)

    u = edge_wind(cor[:, :, :-1], cor[:, :, 1:])  # [6, n+1, n]
    v = edge_wind(cor[:, :-1, :], cor[:, 1:, :])  # [6, n, n+1]
    return depth, u, v


SW_DT, SW_HORD, SW_D2 = 300.0, 5, 0.12  # (a): make_sw_stepper's defaults
SW_STEPS = 48  # (a): C48 steps held against the CPU (4 hours)
# (b): simulated days at C192, dt 600*24/n = 75 s.  The JAX test runs 5
# (tests/test_sw.py, at C24); at ~60 ms a step on the H100 5 days take
# ~350 s of the script's time limit, so the script runs one day, and
# phase_sw_c192(days=5) the five
SW_C192_DAYS = 1
SW_DRIFT_BOUND = 0.08  # tests/test_sw.py: area-weighted L2 height drift
SW_WIND_BOUND = 150.0  # tests/test_sw.py: max |u| (m/s)
SW_TIMED = 30  # (c): timed steps a width, after SW_WARMUP
SW_WARMUP = 3
# launches a SW step: the mass and vorticity transports (K1) and the mass
# filter (K3)
LAUNCHES_SW = dict({k: 0 for k in WRAPPERS}, fv_tp_2d=2, del4_filter=1)
# one C12 x 63 dt of the legacy substep schemes (one tracer): c_half=False
# runs two D stages a substep (a hord-1 half stage without dissipation,
# then the full one): 5 + 5 transports, 2 vertical solves, 4 filters, 2
# column chains; midpoint=False one D stage and no C half-stage
LAUNCHES_C_HALF_FALSE = dict(LAUNCHES_PER_DT, fv_tp_2d=61, sim1_solver=12)
LAUNCHES_FORWARD_BACKWARD = dict(LAUNCHES_PER_DT, column_pressures=6)
DAMPING_RTOL = 1e-5  # combined damping vs the three dampers, f32 sums
REGRID_CONST_RTOL = 1e-6  # a constant field regridded, f32


def sw_state(g, device, dtype=torch.float32, perturb=None):
    """Williamson 2 at g (w2_fields) rounded to f32, as a
    ShallowWaterState in `dtype` on `device`; perturb: a seed of
    parity.perturb_ulp (1-ulp moves of every value)."""
    from fv3net_tpu_torch.convert import sw_state_from_numpy

    arrays = dict(zip(("delp", "u", "v"), (np.asarray(a, np.float32)
                                            for a in w2_fields(g))))
    if perturb is not None:
        arrays = parity.perturb_ulp(arrays, perturb)
    return sw_state_from_numpy(arrays, device, dtype)


def sw_cpu_runs(g, steps, **scheme):
    """The CPU's float64 SW run of `steps` steps from the f32 state and
    its float32 runs from that state and from parity.SPREAD_RUNS 1-ulp
    perturbations of it (the f32 spread)."""
    from fv3net_tpu_torch.dycore import make_sw_stepper

    t0 = time.perf_counter()
    run64, _ = make_sw_stepper(g, SW_DT, SW_HORD, SW_D2, torch.float64,
                               device="cpu", **scheme)
    run32, _ = make_sw_stepper(g, SW_DT, SW_HORD, SW_D2, device="cpu",
                               **scheme)
    ref64 = run64(sw_state(g, "cpu", torch.float64), steps)
    runs32 = [run32(sw_state(g, "cpu", perturb=seed), steps)
              for seed in [None] + list(range(parity.SPREAD_RUNS))]
    say(f"C{g.n} SW CPU runs ({steps} steps, float64 and "
        f"{len(runs32)} float32): {time.perf_counter() - t0:.1f} s")
    return runs32, ref64


def hold_sw(tag, got, runs32, ref64):
    """Every field of a card SW state within the f32 spread of the CPU's
    float64 run (parity.f32_rule)."""
    for k, (err, bnd, scale, errs, finite) in parity.f32_rule(
            got, runs32, ref64).items():
        say(f"{tag} {k:4s} max|f64| {scale:.3e} max|cuda-f64| {err:.3e} "
            f"max|cpu32-f64| {errs[0]:.3e} spread {max(errs):.3e} "
            f"(bound {bnd:.3e})")
        if not (finite and err <= bnd):
            raise AssertionError(f"{tag} {k}: {err:.3e} > {bnd:.3e}")


def sw_mass(state, area):
    return float((state.delp.double().cpu() * area).sum())


def phase_sw_parity():
    """(a) Williamson 2 at C48 through make_sw_stepper on the card, counted
    and held against the CPU; the metric options' run likewise.  Returns
    the path's launches a step."""
    from fv3net_tpu_torch.dycore import make_sw_stepper

    g = CubedSphereGrid.make(48, halo=H)
    run, _ = make_sw_stepper(g, SW_DT, SW_HORD, SW_D2)
    state = sw_state(g, "cuda")
    run(state, 1)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    got = run(state, SW_STEPS)
    torch.cuda.synchronize()
    launches = read_counts()
    check_counts(f"C48 SW {SW_STEPS} steps", launches,
                 {k: SW_STEPS * c for k, c in LAUNCHES_SW.items()})
    hold_sw(f"C48 SW {SW_STEPS} steps", got, *sw_cpu_runs(g, SW_STEPS))

    # (d) the legacy metric options through the same entry point
    options = dict(metric_cwinds=False, metric_ke=False)
    run, m = make_sw_stepper(g, SW_DT, SW_HORD, SW_D2, **options)
    if m.metric_ke or bool(m.cosa_u.any()):
        raise AssertionError("SW metric options not applied")
    got = run(sw_state(g, "cuda"), SW_STEPS)
    hold_sw(f"C48 SW metric options {SW_STEPS} steps", got,
            *sw_cpu_runs(g, SW_STEPS, **options))
    return {k: c // SW_STEPS for k, c in launches.items()}


def phase_sw_c192(days=SW_C192_DAYS):
    """(b) Williamson 2 at C192 for `days` simulated days on the card: the
    JAX test's gates (height drift, winds), total mass in float64 on the
    host, launches of every step."""
    from fv3net_tpu_torch.dycore import make_sw_stepper

    n = 192
    g = CubedSphereGrid.make(n, halo=H)
    dt = 600.0 * 24 / n
    steps = int(days * 86400 / dt)
    run, _ = make_sw_stepper(g, dt, SW_HORD, SW_D2)
    state = sw_state(g, "cuda")
    area = torch.as_tensor(g.area[g.interior])
    mass0 = sw_mass(state, area)
    depth0 = torch.as_tensor(w2_fields(g)[0])  # the analytic steady state
    reset_counts()
    t0 = time.perf_counter()
    out = run(state, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    check_counts(f"C192 SW {steps} steps", launches,
                 {k: steps * c for k, c in LAUNCHES_SW.items()})
    for k, x in out._asdict().items():
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"C192 SW: non-finite {k}")
    h = out.delp.double().cpu()
    l2 = float(torch.sqrt((area * (h - depth0) ** 2).sum()
                          / (area * depth0 ** 2).sum()))
    rel = (sw_mass(out, area) - mass0) / mass0
    umax = float(out.u.abs().max())
    say(f"C192 SW {days} days ({steps} steps of {dt} s) in "
        f"{wall:.1f} s ({wall / steps * 1e3:.3f} ms a step, host clock): "
        f"height L2 drift {l2:.4e} (bound {SW_DRIFT_BOUND}), mass "
        f"{rel:.3e} (bound {MASS_BOUND}), max|u| {umax:.2f} m/s (bound "
        f"{SW_WIND_BOUND})")
    if not (l2 < SW_DRIFT_BOUND and abs(rel) <= MASS_BOUND
            and umax < SW_WIND_BOUND):
        raise AssertionError(f"C192 SW gates: drift {l2}, mass {rel}, "
                             f"|u| {umax}")
    return {k: c // steps for k, c in launches.items()}


def phase_sw_times():
    """(c) ms per SW step at C192 and C384 (CUDA events, median of
    SW_TIMED steps after SW_WARMUP), and K1 and K3 on the arguments the
    step gives them: against their plain versions, CUDA-event ms beside
    the plain versions' and the bound (phase 3's bound()), and
    launches x (ms - bound) a step."""
    from fv3net_tpu_torch.dycore import make_sw_stepper

    for n in (192, 384):
        g = CubedSphereGrid.make(n, halo=H)
        N = n + 2 * H
        run, _ = make_sw_stepper(g, 600.0 * 24 / n, SW_HORD, SW_D2)
        state = sw_state(g, "cuda")
        with Capture(sw, "fv_tp_2d") as tp, \
                Capture(sw, "scalar_filter") as filt:
            state = run(state, SW_WARMUP)
        times = []
        for _ in range(SW_TIMED):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            state = run(state, 1)
            t1.record()
            torch.cuda.synchronize()
            times.append(t0.elapsed_time(t1))
        say(f"C{n} SW ms/step {statistics.median(times):.4f} (median of "
            f"{SW_TIMED}, min {min(times):.4f}, max {max(times):.4f})")
        args, _ = tp.calls[0]  # the mass transport of the last warm-up
        got = fv_tp_2d_cuda(*args)
        want = advection.fv_tp_2d_plain(*args)
        sl = np.s_[:, 2 : N - 2, 2 : N - 2]  # consumed faces
        err = max(check_close(f"C{n} SW K1 {k}", a, b, 1e-4, 1e-3, sl)
                  for k, a, b in zip(("fx", "fy"), got, want))
        stats = {}
        record(stats, "fv_tp_2d", N, err, lambda: fv_tp_2d_cuda(*args),
               lambda: advection.fv_tp_2d_plain(*args), args[:8], got,
               OPS_TP2D_CELL * got[0].numel())
        (q, m, c), _ = filt.calls[0]
        q4 = q[:, None].contiguous()
        got = del4_filter_cuda(q4, m.area_px, m.area_py, c, H)[:, 0]
        want = sw.scalar_filter_plain(q, m, c)
        err = check_close(f"C{n} SW K3", got, want, 1e-4, 1e-5)
        tables = [halo_mod.scalar_gather_flat(n, H, 1, fill, q.device)
                  for fill in ("x", "y")]
        record(stats, "del4_filter", N, err,
               lambda: del4_filter_cuda(q4, m.area_px, m.area_py, c, H),
               lambda: sw.scalar_filter_plain(q, m, c),
               [q, *tables, m.area_px, m.area_py], [got],
               OPS_DEL4_CELL * got.numel())
        for (name, _), r in stats.items():
            loss = LAUNCHES_SW[name] * (r["ms"] - r["bound_ms"])
            say(f"C{n} SW kernel {name} [6, {N}, {N}] max_abs_err "
                f"{r['max_abs_err']:.3e} kernel {r['ms']:.4f} ms plain "
                f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} of it) "
                f"host {r['host_ms']:.4f} ms; launches x (ms - bound) a "
                f"step {loss:.4f} ms")
        del run, state, tp, filt, args, q, m
        torch.cuda.empty_cache()


@contextlib.contextmanager
def substep_scheme(**scheme):
    """Every dyn_substep of the dycore steppers built meanwhile runs with
    `scheme` (make_dycore_stepper exposes c_half, not midpoint)."""
    from fv3net_tpu_torch.dycore import hydro

    real = hydro.dyn_substep
    hydro.dyn_substep = functools.partial(real, **scheme)
    try:
        yield
    finally:
        hydro.dyn_substep = real


def phase_dycore_options():
    """(d) one C12 x 63 dt of each legacy substep scheme on the card
    against the CPU by phase 4's rule, counted; combined_wind_damping
    against the three dampers on the card."""
    n = 12
    g = CubedSphereGrid.make(n, halo=H)
    phis = torch.zeros((6, n, n))
    for tag, scheme, expected in (
            ("c_half=False", dict(c_half=False), LAUNCHES_C_HALF_FALSE),
            ("midpoint=False", {}, LAUNCHES_FORWARD_BACKWARD)):
        patch = (substep_scheme(midpoint=False) if tag == "midpoint=False"
                 else contextlib.nullcontext())
        with patch:
            refs = []
            for dtype in (torch.float32, torch.float64):
                run, _, _ = make_dycore_stepper(
                    g, NZ, DT_ATMOS, k_split=1, n_split=6, hord=5, kord=9,
                    ptop=PTOP, dtype=dtype, device="cpu", **scheme)
                st = benchmark_state(n, NZ, PTOP, "cpu")
                refs.append(run(type(st)(*(x.to(dtype) for x in st)),
                                phis.to(dtype), 1))
            run, _, _ = make_dycore_stepper(
                g, NZ, DT_ATMOS, k_split=1, n_split=6, hord=5, kord=9,
                ptop=PTOP, **scheme)
            state = benchmark_state(n, NZ, PTOP, "cuda")
            reset_counts()
            got = run(state, phis.cuda(), 1)
            torch.cuda.synchronize()
            check_counts(f"C12x63 {tag} one dt", read_counts(), expected)
        compare_states(f"C12x63 {tag}", got, *refs)

    g = CubedSphereGrid.make(48, halo=H)
    m = sw.SWMetrics.make(g)
    rng = np.random.RandomState(22)
    for lead in ((), (NZ,)):
        u = torch.as_tensor(rng.randn(6, *lead, 49, 48).astype(np.float32),
                            device="cuda")
        v = torch.as_tensor(rng.randn(6, *lead, 48, 49).astype(np.float32),
                            device="cuda")
        coef = (SW_D2, sw.VORT_DAMP_COEF, sw.CORNER_DAMP_COEF)
        got = sw.combined_wind_damping(u, v, m, *coef)
        parts = [sw.div_damp(u, v, m, coef[0]),
                 sw.vort_damp(u, v, m, coef[1]),
                 sw.corner_div_damp(u, v, m, coef[2])]
        for i, name in enumerate(("du", "dv")):
            want = sum(p[i] for p in parts)
            err = float((got[i] - want).abs().max())
            scale = float(want.abs().max())
            say(f"C48 combined_wind_damping {name} {list(got[i].shape)}: "
                f"max|combined - three dampers| {err:.3e} of max "
                f"{scale:.3e} (bound {DAMPING_RTOL} x max)")
            if not err <= DAMPING_RTOL * scale:
                raise AssertionError(f"combined_wind_damping {name}: {err}")


def phase_regrid():
    """(e) FregridLatLon at C48 -> 90 x 180 on the card: a seeded
    [6, 63, 48, 48] f32 field against the CPU's float64 regrid by phase
    4's rule, a constant field, and the times."""
    from fv3net_tpu_torch.regrid import FregridLatLon

    n = 48
    t0 = time.perf_counter()
    rg = FregridLatLon(CubedSphereGrid.make(n, halo=H), 90, 180)
    say(f"C{n} -> 90x180 regrid weights: {len(rg.w)} triplets in "
        f"{time.perf_counter() - t0:.2f} s (host, g++ build included)")
    q = (250.0 + 30.0 * np.random.RandomState(23).rand(6, NZ, n, n)
         ).astype(np.float32)
    t0 = time.perf_counter()
    got = rg.regrid(q)  # a host array, no device: the card
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    if got.device.type != "cuda" or got.shape != (NZ, 90, 180):
        raise AssertionError(f"regrid: {got.device} {tuple(got.shape)}")
    cpu32 = rg.regrid(torch.as_tensor(q))
    ref64 = rg.regrid(q.astype(np.float64), device="cpu")
    compare_states(f"C{n} regrid", {"q": got}, {"q": cpu32}, {"q": ref64})
    qd = torch.as_tensor(q, device="cuda")
    ms = cuda_ms(lambda: rg.regrid(qd))
    const = rg.regrid(torch.full((6, n, n), 5.0, device="cuda"))
    filled = const.cpu()[torch.as_tensor(rg.dst_area.reshape(90, 180) > 0)]
    err = float((filled - 5.0).abs().max() / 5.0)
    say(f"C{n} regrid [6, {NZ}, {n}, {n}] -> [{NZ}, 90, 180]: "
        f"{wall:.3f} ms wall from a host array (copies included), "
        f"{ms:.4f} ms (CUDA events) on a card tensor; a constant "
        f"field {err:.3e} relative (bound {REGRID_CONST_RTOL})")
    if not err <= REGRID_CONST_RTOL:
        raise AssertionError(f"regrid of a constant: {err:.3e}")



# --- phases 23-25: multiband radiation and the multi-rank dycore ------------

RAD_TIME = datetime.datetime(2016, 8, 1, 12)
RAD_REPS = 10
# energy closure, the tolerances of the JAX package's
# tests/test_radiation.py::test_{sw,lw}_energy_conservation (rtol, atol in
# W/m^2): TOA net SW = column absorption + surface net SW; column LW
# heating = -(net flux at the top - net flux at the surface)
SW_CLOSURE = (2e-3, 0.5)
LW_CLOSURE = (1e-4, 1e-3)
# the multi-rank dycore (parallel/spmd_dycore.py) on this one card: every
# rank a process of one gloo group, its state, compute and kernels on the
# card, only the exchange payloads through the host
SPMD_MESHES = {"face": 6, "tiled": 8}  # ranks
SPMD_LAYOUT = (2, 2, 2)  # the tiled mesh: (F, Y, X), three faces a rank
SPMD_GATE_DTS = {"face": 2, "tiled": 1}  # dts held against the references
SPMD_TIMED_DTS = 3  # further dts timed, after the held ones
SPMD_TIMEOUT_S = 600  # the ranks' wall-time limit
SPMD_DIST_TIMEOUT_S = 300  # every exchange and collective
# the sharded card dt against the single-process card dt: bit for bit
# where two single-process dts agree bit for bit; otherwise within this
# factor of their difference (autograd's atomic scatter-add in div_damp's
# transpose makes the single-process card dt irreproducible in f32)
SPMD_SPREAD_FACTOR = 4.0
SPMD_CPU_N = 12  # the float64 CPU run of the same meshes: C12 x 63
SPMD_CPU_TOL = 1e-12  # against the single-process float64 dt (rtol, atol)
LAUNCHES_SPMD_FACE = dict(LAUNCHES_PER_DT, del4_filter=0,
                          del4_filter_pair=24)
# on tiles the filter takes its plain transpose form (sw.scalar_filter)
LAUNCHES_SPMD_TILED = dict(LAUNCHES_PER_DT, del4_filter=0)
_CPU_REFS = {}  # n -> phase 5's CPU f32 and float64 dts


def radiation_inputs(n, nz=NZ, seed=0):
    """A seeded C`n` x nz radiation state (host float64): hybrid-coordinate
    pressures with surface pressure +-2%, a lapse-rate temperature with
    noise, humidity from dry to saturated, condensate in some cells, land
    on ~40% of the columns and snow on half of the land, and the grid's
    own longitudes and latitudes (degrees)."""
    rng = np.random.RandomState(seed)
    g = CubedSphereGrid.make(n, halo=H)
    lon, lat = (np.rad2deg(a[g.interior]) for a in (g.lon, g.lat))
    ak, bk = (c.numpy() for c in hybrid_coefficients(nz, PTOP))
    ps = 1.0e5 * (1.0 + 0.02 * rng.randn(6, 1, n, n))
    pe = ak[None, :, None, None] + bk[None, :, None, None] * ps
    delp = pe[:, 1:] - pe[:, :-1]
    p_lay = 0.5 * (pe[:, 1:] + pe[:, :-1])
    temp = np.clip(
        288.0 - 60.0 * np.log(1.0e5 / p_lay) / np.log(10.0), 200.0, 320.0
    ) + rng.randn(6, nz, n, n)
    sphum = 0.015 * (p_lay / 1.0e5) ** 3 * rng.rand(6, nz, n, n) + 1e-6
    ql = np.where(rng.rand(6, nz, n, n) < 0.2, 1e-4 * rng.rand(6, nz, n, n),
                  0.0)
    qi = np.where(rng.rand(6, nz, n, n) < 0.1, 5e-5 * rng.rand(6, nz, n, n),
                  0.0)
    land = (rng.rand(6, n, n) < 0.4).astype(np.float64)
    snow = np.where(rng.rand(6, n, n) < 0.5, 25.0 * rng.rand(6, n, n), 0.0)
    snow = snow * land
    tsfc = 280.0 + 20.0 * np.cos(np.deg2rad(lat)) + rng.randn(6, n, n)
    return dict(p_lay=p_lay, delp=delp, temp=temp, sphum=sphum, ql=ql,
                qi=qi, tsfc=tsfc, land_mask=land, snow=snow, lon=lon,
                lat=lat)


def radiation_call(drv, inp, device, dtype):
    """MultibandRadiationDriver.gfs_radiation_driver on tensors of
    `dtype` on `device` built from the host inputs (lon/lat stay host)."""
    t = {k: torch.as_tensor(v, dtype=dtype, device=device)
         for k, v in inp.items() if k not in ("lon", "lat")}
    return lambda: drv.gfs_radiation_driver(
        RAD_TIME, inp["lon"], inp["lat"], t["p_lay"], t["delp"], t["temp"],
        t["sphum"], t["tsfc"], ql=t["ql"], qi=t["qi"],
        land_mask=t["land_mask"], snow=t["snow"],
    )


def radiation_closure(tag, out, delp):
    """The energy closure of the SW and LW solvers (SW_CLOSURE,
    LW_CLOSURE), in float64 from the driver's outputs."""
    from fv3net_tpu_torch.constants import CP_AIR

    o = {k: v.double().cpu() for k, v in out.items()}
    dp = delp.double().cpu()
    colabs = (o["shortwave_heating_rate"] * dp).sum(1) * CP_AIR / GRAV
    toa_net = (o["total_sky_downward_shortwave_flux_at_top_of_atmosphere"]
               - o["total_sky_upward_shortwave_flux_at_top_of_atmosphere"])
    sfc_net = o["total_sky_net_shortwave_flux_at_surface"]
    colheat = (o["longwave_heating_rate"] * dp).sum(1) * CP_AIR / GRAV
    net_top = o["total_sky_upward_longwave_flux_at_top_of_atmosphere"]
    net_sfc = (o["total_sky_upward_longwave_flux_at_surface"]
               - o["total_sky_downward_longwave_flux_at_surface"])
    for name, actual, desired, (rtol, atol) in (
        ("SW", toa_net, colabs + sfc_net, SW_CLOSURE),
        ("LW", colheat, -(net_top - net_sfc), LW_CLOSURE),
    ):
        err = (actual - desired).abs()
        worst = float((err - rtol * desired.abs()).max())
        say(f"{tag} {name} energy closure: max |err| {float(err.max()):.3e} "
            f"W/m^2 (rtol {rtol}, atol {atol}; worst excess over rtol "
            f"{worst:.3e})")
        if not worst <= atol:
            raise AssertionError(f"{tag}: {name} energy not closed")
    if not float(colabs.min()) >= -1e-3:
        raise AssertionError(f"{tag}: negative SW column absorption")


def phase_radiation():
    """The multiband radiation (physics/radiation.py
    MultibandRadiationDriver) at C48 x 63 on the card against the CPU in
    f32 and float64 by phase 4's rule; the energy closure of its solvers;
    ms per call (CUDA events), wall ms and the device's busy time
    (torch.profiler) beside them."""
    from fv3net_tpu_torch.physics.radiation import MultibandRadiationDriver

    inp = radiation_inputs(48)
    drv = MultibandRadiationDriver()
    drv.radupdate(RAD_TIME)
    card_call = radiation_call(drv, inp, "cuda", torch.float32)
    got = card_call()  # the first call captures drv._jit
    eager_call = eagerly(card_call)
    hold_replay("radiation C48x63", got, eager_call(), eager_call())
    torch.cuda.synchronize()
    runs = {}
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        runs[dtype] = radiation_call(drv, inp, "cpu", dtype)()
        say(f"radiation C48x63 CPU {dtype}: {time.perf_counter() - t0:.1f} s")
    compare_states("radiation C48x63", got, runs[torch.float32],
                   runs[torch.float64])
    day = got["total_sky_downward_shortwave_flux_at_top_of_atmosphere"]
    if not float(day.max()) > 600.0 or float(day.min()) != 0.0:
        raise AssertionError("radiation: no day and night on the cube")
    delp32 = torch.as_tensor(inp["delp"], dtype=torch.float32)
    radiation_closure("radiation C48x63 card", got, delp32)
    radiation_closure("radiation C48x63 f64", runs[torch.float64],
                      torch.as_tensor(inp["delp"]))
    ms = ab_calls("radiation C48x63", eager_call, card_call, RAD_REPS)
    walls = {"eager": [], "replay": []}
    for i in range(RAD_REPS):
        for k in (("eager", "replay") if i % 2 == 0 else ("replay", "eager")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (eager_call if k == "eager" else card_call)()
            torch.cuda.synchronize()
            walls[k].append((time.perf_counter() - t0) * 1e3)
    cuda_t = torch.autograd.DeviceType.CUDA
    for k, fn in (("eager", eager_call), ("replay", card_call)):
        wall = statistics.median(walls[k])
        with device_profile() as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == cuda_t]
        busy = device_busy_ms(prof)
        say(f"radiation C48x63 {k}: {ms[k]:.3f} ms a call (CUDA events, "
            f"median of {RAD_REPS}), wall {wall:.3f} ms, device busy "
            f"{busy:.3f} ms ({len(kernels)} device ops), host share "
            f"{1.0 - busy / wall:.3f} of the wall time")


def _spmd_stepper(mode, mesh, n, device, dtype):
    from fv3net_tpu_torch.parallel import spmd_dycore
    from fv3net_tpu_torch.parallel.tiling import TileLayout

    g = CubedSphereGrid.make(n, halo=H)
    kw = dict(dt_atmos=DT_ATMOS, k_split=1, n_split=6, hord=5, kord=9,
              ptop=PTOP, dtype=dtype, device=device)
    if mode == "face":
        return spmd_dycore.make_spmd_dycore_stepper(g, NZ, mesh, **kw)
    lay = TileLayout(n, H, *SPMD_LAYOUT)
    return spmd_dycore.make_tiled_spmd_dycore_stepper(g, NZ, mesh, lay, **kw)


def spmd_rank(mode, outdir):
    """One rank of phase 24 (face) or 25 (tiled): `python3 chip_smoke.py
    --rank MODE DIR`, started by multihost.spawn.  The card run of C48 x
    63: the held dts (their gathered states to DIR from rank 0), then the
    timed ones; then the float64 CPU run of C12 x 63 (rank 0 saves it)."""
    import torch.distributed as dist

    from fv3net_tpu_torch.parallel import multihost
    from fv3net_tpu_torch.parallel.mesh import CubedSphereMesh, make_mesh

    rank, world = multihost.initialize()
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank}: no GPU")
    torch.set_num_threads(1)
    mesh = (make_mesh() if mode == "face"
            else CubedSphereMesh(SPMD_LAYOUT[0], 1, *SPMD_LAYOUT[1:],
                                 rank=rank))
    t0 = time.perf_counter()
    run, shard, gather = _spmd_stepper(mode, mesh, 48, "cuda",
                                       torch.float32)
    setup_s = time.perf_counter() - t0
    st, phis = shard(benchmark_state(48, NZ, PTOP, "cpu"),
                     torch.zeros((6, 48, 48)))
    comm = run.comm
    held, dts = [], []
    for i in range(SPMD_GATE_DTS[mode] + SPMD_TIMED_DTS):
        dist.barrier()
        reset_counts()
        comm.reset_counts()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        w0 = time.perf_counter()
        t0.record()
        st = run(st, phis, 1)
        t1.record()
        torch.cuda.synchronize()
        dts.append(dict(
            ms=t0.elapsed_time(t1), wall_ms=(time.perf_counter() - w0) * 1e3,
            exchange_ms=comm.seconds * 1e3, copy_ms=comm.copy_seconds * 1e3,
            wait_ms=comm.wait_seconds * 1e3, exchanges=comm.calls,
            exchange_mb=comm.bytes / 1e6, launches=read_counts(),
        ))
        if i < SPMD_GATE_DTS[mode]:
            held.append({k: v.cpu() for k, v in gather(st)._asdict().items()
                         if v is not None})
    run64, shard64, gather64 = _spmd_stepper(mode, mesh, SPMD_CPU_N, "cpu",
                                             torch.float64)
    st0 = benchmark_state(SPMD_CPU_N, NZ, PTOP, "cpu")
    st64, ph64 = shard64(
        type(st0)(*(None if x is None else x.double() for x in st0)),
        torch.zeros((6, SPMD_CPU_N, SPMD_CPU_N), dtype=torch.float64),
    )
    cpu64 = gather64(run64(st64, ph64, 1))
    if rank == 0:
        torch.save({"held": held,
                    "cpu64": {k: v for k, v in cpu64._asdict().items()
                              if v is not None}},
                   os.path.join(outdir, "states.pt"))
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump({"dts": dts, "setup_s": setup_s}, f)
    dist.destroy_process_group()


def spread_gate(tag, got, run_a, run_b):
    """The sharded card state against the single-process card state: bit
    for bit where two single-process runs agree bit for bit, otherwise
    within SPMD_SPREAD_FACTOR of their difference, per field."""
    for k, a in run_a.items():
        g = got[k].to(a.device)
        spread = float((a - run_b[k]).abs().max())
        err = float((g - a).abs().max())
        say(f"{tag} {k:5s} max|sharded-single| {err:.3e} "
            f"max|single-single| {spread:.3e}")
        if spread == 0.0:
            if not torch.equal(g, a):
                raise AssertionError(f"{tag} {k}: not bit for bit")
        elif not err <= SPMD_SPREAD_FACTOR * spread:
            raise AssertionError(
                f"{tag} {k}: {err:.3e} > {SPMD_SPREAD_FACTOR} x {spread:.3e}")


def phase_spmd(mode):
    """Phase 24 (face) or 25 (tiled): the multi-rank dycore at C48 x 63 on
    this card (module docstring)."""
    from fv3net_tpu_torch.parallel import multihost

    n = 48
    g = CubedSphereGrid.make(n, halo=H)
    # the single-process references, before the ranks start: two card
    # runs of the held dts and the float64 CPU dt of C12
    run1, m, _ = stepper(g, "cuda")
    phis = torch.zeros((6, n, n), device="cuda")
    mass0 = dry_mass(benchmark_state(n, NZ, PTOP, "cuda"), m)
    singles = []
    for _ in range(2):
        s, out = benchmark_state(n, NZ, PTOP, "cuda"), []
        for _ in range(SPMD_GATE_DTS[mode]):
            s = run1(s, phis, 1)
            out.append({k: v for k, v in s._asdict().items()
                        if v is not None})
        singles.append(out)
    torch.cuda.synchronize()
    g12 = CubedSphereGrid.make(SPMD_CPU_N, halo=H)
    run64, _, _ = stepper(g12, "cpu", torch.float64)
    st0 = benchmark_state(SPMD_CPU_N, NZ, PTOP, "cpu")
    ref64 = run64(type(st0)(*(None if x is None else x.double()
                              for x in st0)),
                  torch.zeros((6, SPMD_CPU_N, SPMD_CPU_N),
                              dtype=torch.float64), 1)
    nprocs = SPMD_MESHES[mode]
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as d:
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, FV3_DIST_TIMEOUT=str(SPMD_DIST_TIMEOUT_S),
                   PYTHONPATH=os.pathsep.join(
                       [root, os.environ.get("PYTHONPATH", "")]))
        t0 = time.perf_counter()
        multihost.spawn([os.path.abspath(__file__), "--rank", mode, d],
                        nprocs, os.path.join(d, "store"),
                        timeout_s=SPMD_TIMEOUT_S, env=env).wait()
        say(f"spmd {mode}: {nprocs} ranks ran in "
            f"{time.perf_counter() - t0:.1f} s")
        ranks = [json.load(open(os.path.join(d, f"rank{r}.json")))
                 for r in range(nprocs)]
        states = torch.load(os.path.join(d, "states.pt"))
    tag = f"spmd {mode} C48x63"
    expected = LAUNCHES_SPMD_FACE if mode == "face" else LAUNCHES_SPMD_TILED
    for r, rk in enumerate(ranks):
        for i, dt in enumerate(rk["dts"]):
            if dt["launches"] != expected:
                raise AssertionError(
                    f"{tag} rank {r} dt {i}: launches {dt['launches']}")
    check_counts(f"{tag} one dt, each rank", ranks[0]["dts"][0]["launches"],
                 expected)
    for i, held in enumerate(states["held"]):
        for k, v in held.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{tag}: non-finite {k}")
        if mode == "face":
            spread_gate(f"{tag} dt {i + 1}", held, singles[0][i],
                        singles[1][i])
        else:
            # the tiled step takes the filter's and the vorticity
            # damper's transpose forms (the JAX package's tiled path), not
            # the single-process arithmetic: held by phase 4's rule
            for k, a in singles[0][i].items():
                say(f"{tag} {k:5s} max|tiled-single| "
                    f"{float((held[k].cuda() - a).abs().max()):.3e}")
        if i == 0:
            compare_states(tag, held, *cpu_references(g, n))
        mass = float((held["delp"].to(m.rarea.device).double()
                      / m.rarea.double()[:, None]).sum())
        rel = (mass - mass0) / mass0
        say(f"{tag} dry mass relative change after dt {i + 1}: {rel:.3e}")
        if not abs(rel) <= MASS_BOUND:
            raise AssertionError(f"{tag}: dry mass not conserved")
    want = {k: v for k, v in ref64._asdict().items() if v is not None}
    bitwise = True
    for k, w in want.items():
        got = states["cpu64"][k]
        bitwise &= torch.equal(got, w)
        err = float((got - w).abs().max())
        say(f"{tag} CPU float64 C{SPMD_CPU_N} {k:5s} max|sharded-single| "
            f"{err:.3e}")
        if not bool(((got - w).abs()
                     <= SPMD_CPU_TOL + SPMD_CPU_TOL * w.abs()).all()):
            raise AssertionError(f"{tag}: CPU float64 {k} beyond 1e-12")
    say(f"{tag} CPU float64 C{SPMD_CPU_N}: bit for bit {bitwise}")
    timed = [dt for rk in ranks for dt in rk["dts"][SPMD_GATE_DTS[mode]:]]
    slowest = [max(rk["dts"][SPMD_GATE_DTS[mode] + j]["ms"] for rk in ranks)
               for j in range(SPMD_TIMED_DTS)]
    ms = statistics.median(slowest)
    def med(key):
        return statistics.median(dt[key] for dt in timed)

    say(f"{tag}: ms/dt {ms:.3f} (median over {SPMD_TIMED_DTS} dts of the "
        f"slowest rank's CUDA-event time: {[round(x, 3) for x in slowest]}), "
        f"wall ms/dt {med('wall_ms'):.3f}, "
        f"exchanges {timed[0]['exchanges']} a dt taking "
        f"{med('exchange_ms'):.3f} ms a rank (median; of it "
        f"{med('copy_ms'):.3f} ms device-host copies, the rest messages "
        f"and waiting for peers), after {med('wait_ms'):.3f} ms spent "
        f"waiting for the rank's own queued work before the exchanges, "
        f"{statistics.median(dt['exchange_mb'] for dt in timed):.3f} MB sent "
        f"a rank; first dt {max(rk['dts'][0]['ms'] for rk in ranks):.1f} ms; "
        f"stepper set-up {max(rk['setup_s'] for rk in ranks):.1f} s")
    return ranks[0]["dts"][0]["launches"]


def width(name, n):
    """The width a kernel's phase-3 numbers are keyed by on the C<n> path:
    the interior n for the kernels that run on the interior columns (the
    vertical solve and the remap), the padded n + 2H for the others."""
    return n if name in INTERIOR else n + 2 * H


def kernel_summary(stats, probe_launches, paths):
    """The kernels' JSON entries: each kernel's launches from the path
    that runs it (K1-K5 from the coupled C48 path, K6 from the C192 path)
    beside its launches on every path (`paths`: name -> launches a step,
    all at C48 but "C192 fused" and "C384 fused", of the whole C384 -> C48
    coarsening for "coarsening C384", and a shallow-water step for "sw"),
    and its
    phase-3 numbers at that path's shapes (the probes at theirs); prints
    launches x (time - bound) of each kernel on each path whose width
    phase 3 times (not C384's, not the single-layer "sw")."""
    by_path = dict({"probe": probe_launches}, **paths)
    counted = dict(paths["coupled C48"],
                   fv_tp_2d_multi5=paths["C192 fused"]["fv_tp_2d_multi5"],
                   del4_filter_pair=paths["spmd face C48"]["del4_filter_pair"],
                   probe_affine=probe_launches["probe_affine"],
                   probe_stencil=probe_launches["probe_stencil"])
    shape = dict({k: width(k, 48) for k in META}, fv_tp_2d_multi5=198,
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
            "host_ms": r["host_ms"],
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
        })
        if name.startswith("probe_"):
            big = stats[(name, PROBE_BIG[0])]
            kernels[-1].update(
                device_ms=r["device_ms"],
                library_device_ms=r["library_device_ms"],
                at_16384=dict(big))
    for tag, launches in paths.items():
        if tag == "sw" or tag.startswith("spmd"):
            # single-layer or shard shapes, which phase 3 does not time
            # (phase 22 prints the SW step's loss)
            continue
        n = {"C192 fused": 192, "C384 fused": 384,
             "coarsening C384": 384}.get(tag, 48)
        loss = {
            k: round(c * (stats[(k, width(k, n))]["ms"]
                          - stats[(k, width(k, n))]["bound_ms"]), 4)
            for k, c in launches.items() if c and (k, width(k, n)) in stats
        }
        say(f"{tag}: launches x (kernel ms - bound ms) per step {loss}")
    return kernels


def timed(name, fn, *args):
    """fn(*args), its wall seconds printed as phase `name`'s."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        say(f"phase {name}: {time.perf_counter() - t0:.1f} s")


def main():
    t0 = time.perf_counter()
    timed("device", phase_device)
    timed("build", phase_build)
    probe_launches, stats = timed("probe", phase_probe)
    stats.update(timed("kernels", phase_kernels))
    report_kernels(stats)
    timed("slice parity", phase_slice_parity)
    main_launches = timed("main path C48", phase_main_path)
    fused_launches = timed("C192 fused", phase_c192_path)
    c384_launches = timed("C384 fused", phase_c384_path)
    timed("transposes", phase_transposes)
    os.makedirs(os.path.dirname(DENSE_DIR), exist_ok=True)
    timed("coupled parity", phase_coupled_parity)
    coupled_launches = timed("coupled C48", phase_coupled_path)
    timed("hydrostatic parity", phase_hydrostatic_parity)
    timed("units", phase_units)
    prognostic_launches = timed("prognostic run", phase_prognostic_run)
    timed("nudged parity", phase_nudged_parity)
    nudged_launches, case = timed("nudged run", phase_nudged_run)
    model_dir = timed("training", phase_training, case.name)
    ml_launches = timed("ML run", phase_ml_run, case.name, model_dir)
    emulated_launches = timed("emulated run", phase_emulated_run, case.name)
    series_launches, series_path = timed("series", phase_series_run,
                                         case.name)
    graph_dir = timed("families", phase_families, case.name, series_path)
    timed("offline", phase_offline, case.name, model_dir, graph_dir)
    timed("diagnostics", phase_diagnostics, case.name)
    case.cleanup()
    coarsening_launches = timed("coarsening", phase_coarsening)
    sw_launches = timed("SW parity", phase_sw_parity)
    if timed("SW C192", phase_sw_c192) != sw_launches:
        raise AssertionError("SW launches a step differ at C48 and C192")
    timed("SW times", phase_sw_times)
    timed("dycore options", phase_dycore_options)
    timed("regrid", phase_regrid)
    timed("radiation", phase_radiation)
    spmd_face_launches = timed("spmd face", phase_spmd, "face")
    spmd_tiled_launches = timed("spmd tiled", phase_spmd, "tiled")
    kernels = kernel_summary(stats, probe_launches, {
        "C48": main_launches, "C192 fused": fused_launches,
        "C384 fused": c384_launches,
        "coupled C48": coupled_launches,
        "prognostic C48": prognostic_launches, "nudged C48": nudged_launches,
        "ML-corrected C48": ml_launches, "emulated C48": emulated_launches,
        "series C48": series_launches,
        "coarsening C384": coarsening_launches, "sw": sw_launches,
        "spmd face C48": spmd_face_launches,
        "spmd tiled C48": spmd_tiled_launches})
    say(f"all phases: {time.perf_counter() - t0:.1f} s")
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
    import sys

    if sys.argv[1:2] == ["--rank"]:
        spmd_rank(*sys.argv[2:4])
    else:
        main()
