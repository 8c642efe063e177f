"""The benchmark of fv3net_tpu_torch on one NVIDIA H100 (see README.md)."""
