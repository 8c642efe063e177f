"""Multi-rank cubed-sphere runs (the JAX package's ``parallel/``): meshes
of process ranks on torch.distributed or of the shards of one process
(mesh.py), the face-mesh exchanges (halo_spmd.py), within-face tiling
(tiling.py), the multi-rank dycore (spmd_dycore.py) and the process
runtime (multihost.py)."""

from .mesh import (
    CubedSphereMesh,
    LocalMesh,
    global_mean,
    make_local_mesh,
    make_mesh,
    shard_state,
)

__all__ = ["CubedSphereMesh", "LocalMesh", "make_mesh", "make_local_mesh",
           "shard_state", "global_mean"]
