"""Rank meshes for the cubed sphere over a torch.distributed process group.

Counterpart of the JAX package's ``parallel/mesh.py``: the replacement
of the reference's MPI domain decomposition (pace.util
CubedSpherePartitioner / TilePartitioner + ``mpirun -n 6xy``).  Where the
JAX package places global arrays on a device mesh, here every rank is
one process that holds its own slice: ``shard_state`` hands each rank
its faces (and levels), ``global_mean`` reduces over the ranks with an
``all_reduce``.

Rank order is (face, y, x, z) row-major: rank = ((f*Y + y)*X + x)*Z + z
for face shard f, within-face tile (y, x) and level shard z.  Layout
policy (the 6*x*y rank-count rule of runtime/segmented_run/run.py:34-35),
as the JAX package's:
    n_ranks in {1, 2, 3, 6}: shard faces only
    otherwise: the largest face factor in {6, 3, 2, 1} x z-sharding
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from .halo_spmd import Comm


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass
class CubedSphereMesh:
    """A rank mesh with the cube's face axis first: ``face_shards`` face
    blocks of 6/face_shards faces, each cut into ``y_shards`` x
    ``x_shards`` tiles, each replicated over ``z_shards`` level shards."""

    face_shards: int
    z_shards: int = 1
    y_shards: int = 1
    x_shards: int = 1
    rank: int = 0
    _comms: dict = dataclasses.field(default_factory=dict, repr=False)
    _groups: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_devices(self) -> int:
        return self.face_shards * self.y_shards * self.x_shards * self.z_shards

    def coords(self, rank: Optional[int] = None):
        """(face shard, tile row, tile column, level shard) of a rank."""
        r = self.rank if rank is None else rank
        r, z = divmod(r, self.z_shards)
        r, x = divmod(r, self.x_shards)
        f, y = divmod(r, self.y_shards)
        return f, y, x, z

    @property
    def faces(self) -> range:
        """The faces this rank holds."""
        L = 6 // self.face_shards
        f = self.coords()[0]
        return range(f * L, (f + 1) * L)

    def _plane_ranks(self):
        """The ranks of this rank's level shard, in (face, y, x) order."""
        z = self.coords()[3]
        D = self.face_shards * self.y_shards * self.x_shards
        return [d * self.z_shards + z for d in range(D)]

    @property
    def face_comm(self) -> Comm:
        """The Comm of the (face, y, x) ranks of this level shard: the
        exchange axis of the face mesh and of the tiled mesh."""
        if "plane" not in self._comms:
            self._comms["plane"] = Comm(self._plane_ranks())
        return self._comms["plane"]

    def plane_group(self):
        """The process group of face_comm's ranks (WORLD when z_shards is
        1; made by make_mesh otherwise)."""
        return self._groups.get("plane")


def _face_factor(n: int) -> int:
    for f in (6, 3, 2):
        if n % f == 0:
            return f
    return 1


def make_mesh(n_devices: Optional[int] = None) -> CubedSphereMesh:
    """The (face, z) mesh over the process group's ranks (all of them by
    default).  Collective: every rank calls it."""
    rank, world = _world()
    n = n_devices or world
    if n > world:
        raise ValueError(f"make_mesh({n}) on a group of {world} ranks")
    f = _face_factor(n)
    csm = CubedSphereMesh(f, n // f, rank=rank)
    if csm.z_shards > 1:
        for z in range(csm.z_shards):
            ranks = [d * csm.z_shards + z for d in range(f)]
            group = dist.new_group(ranks=ranks)
            if rank in ranks:
                csm._groups["plane"] = group
    return csm


def shard_state(state, csm: CubedSphereMesh):
    """This rank's slice of a DycoreState (or a dict, list or tuple of
    [6, nz, ...] tensors): the faces of its face shard and, where the
    level axis divides, the levels of its level shard; other tensors
    (a tracer stack whose first axis is not the face axis, scalars) whole.
    The JAX package's placement rule, as a slice."""
    f = csm.coords()[0]
    z = csm.coords()[3]
    L = 6 // csm.face_shards

    def place(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.ndim >= 2 and x.shape[0] == 6:
            x = x[f * L : (f + 1) * L]
            if x.ndim > 2 and x.shape[1] % csm.z_shards == 0:
                k = x.shape[1] // csm.z_shards
                x = x[:, z * k : (z + 1) * k]
        return x

    if isinstance(state, dict):
        return {k: place(v) for k, v in state.items()}
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*[place(x) for x in state])
    if isinstance(state, (list, tuple)):
        return type(state)(place(x) for x in state)
    return place(state)


def global_mean(field, area, csm: Optional[CubedSphereMesh] = None):
    """Area-weighted global mean (the comm.reduce replacement of
    runtime/metrics.py:18-33).  Without a mesh, of whole arrays; with
    one, of this rank's face slices (shard_state's), summed over the
    ranks of one level shard with an all_reduce (float64 on the host)."""
    num = torch.sum(field * area)
    den = torch.sum(area)
    if csm is None or csm.n_devices == 1:
        return num / den
    sums = torch.stack([num, den]).detach().to("cpu", torch.float64)
    dist.all_reduce(sums, group=csm.plane_group())
    return (sums[0] / sums[1]).to(field.device, field.dtype)
