"""fv3net_tpu_torch: fv3net_tpu's dynamical core and prognostic run in
PyTorch and CUDA.

A port of the JAX package ``fv3net_tpu`` (which stays the reference) to
PyTorch, with the TPU's Pallas kernels replaced by CUDA C++ kernels
written for Hopper (``csrc/``, built with nvcc at first use).  Imports
torch and numpy only.

Layout:
    grid/      cubed-sphere geometry and topology (numpy), halo gathers
    ops/       transport, vertical remap, the CUDA kernel wrappers
    dycore/    the hydrostatic and nonhydrostatic dynamical core step
    physics/   simple suite, Held-Suarez, GFS suite, gray radiation
    fit/       the dense ML model
    wrapper    the fv3gfs.wrapper API over the model (per-phase steps)
    runtime/   TimeLoop, steppers, diagnostics, metrics, segmented runs,
               the runfv3 CLI, and the coupled step (compiled_loop)
    io/, utils/, util/   zarr-lite store, thermo, rotation, logs,
               lineage breadcrumbs, Quantity
    convert    numpy <-> torch conversion of metrics and state
"""

__version__ = "0.1.0"
