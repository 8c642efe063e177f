"""Multi-rank cubed-sphere runs on torch.distributed (the JAX package's
``parallel/``): rank meshes (mesh.py), the face-mesh exchanges
(halo_spmd.py), within-face tiling (tiling.py), the multi-rank dycore
(spmd_dycore.py) and the process runtime (multihost.py)."""

from .mesh import CubedSphereMesh, global_mean, make_mesh, shard_state

__all__ = ["CubedSphereMesh", "make_mesh", "shard_state", "global_mean"]
