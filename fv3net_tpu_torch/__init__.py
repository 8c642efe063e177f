"""fv3net_tpu_torch: the fv3net_tpu dynamical core in PyTorch and CUDA.

A port of the JAX package ``fv3net_tpu`` (which stays the reference) to
PyTorch, with the TPU's Pallas kernels replaced by CUDA C++ kernels
written for Hopper (``csrc/``, built with nvcc at first use).  Imports
torch and numpy only.

Layout:
    grid/      cubed-sphere geometry and topology (numpy), halo gathers
    ops/       transport, vertical remap, the CUDA kernel wrappers
    dycore/    the nonhydrostatic dynamical core step
    convert    numpy <-> torch conversion of metrics and state
"""

__version__ = "0.1.0"
