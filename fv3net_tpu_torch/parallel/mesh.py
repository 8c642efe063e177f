"""Meshes for the cubed sphere: ranks of a torch.distributed process
group, or the shards of one process.

Counterpart of the JAX package's ``parallel/mesh.py``: the replacement
of the reference's MPI domain decomposition (pace.util
CubedSpherePartitioner / TilePartitioner + ``mpirun -n 6xy``).  Where the
JAX package places global arrays on a device mesh, a process rank holds
its own slice: ``shard_state`` hands each rank its faces (and levels),
``global_mean`` reduces over the ranks with an ``all_reduce``.  The JAX
package's own form, one process driving a ``Mesh`` of its local devices
(``make_mesh`` over ``jax.devices()``), is ``LocalMesh``
(``make_local_mesh``): the (face, y, x) shards of one process on one
device, each run by a thread of its own, exchanging device tensors
(``halo_spmd.LocalComm``); ``global_mean`` over it stays on the device.

Rank order is (face, y, x, z) row-major: rank = ((f*Y + y)*X + x)*Z + z
for face shard f, within-face tile (y, x) and level shard z.  Layout
policy (the 6*x*y rank-count rule of runtime/segmented_run/run.py:34-35),
as the JAX package's:
    n_ranks in {1, 2, 3, 6}: shard faces only
    otherwise: the largest face factor in {6, 3, 2, 1} x z-sharding
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..graphs import _tensors
from ..ops import _build
from .halo_spmd import Comm, LocalComm, LocalHub

# how long a shard of a local mesh waits at an exchange for its peers (the
# process group's default timeout, multihost.DEFAULT_TIMEOUT_S)
LOCAL_TIMEOUT_S = 300.0


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


def global_mean(field, area, csm=None):
    """Area-weighted global mean (the comm.reduce replacement of
    runtime/metrics.py:18-33).  Without a mesh, of whole arrays; with a
    CubedSphereMesh, of this rank's face slices (shard_state's), summed
    over the ranks of one level shard with an all_reduce (float64 on the
    host); with a LocalMesh, `field` and `area` are sequences of every
    shard's slices, and the sums are taken in shard order in float64 on
    their device (no host read): a 0-d tensor of field's dtype."""
    if isinstance(csm, LocalMesh):
        sums = torch.stack([
            torch.stack([torch.sum(f * a), torch.sum(a)])
            for f, a in zip(field, area)
        ]).double().sum(0)
        return (sums[0] / sums[1]).to(field[0].dtype)
    num = torch.sum(field * area)
    den = torch.sum(area)
    if csm is None or csm.n_devices == 1:
        return num / den
    sums = torch.stack([num, den]).detach().to("cpu", torch.float64)
    dist.all_reduce(sums, group=csm.plane_group())
    return (sums[0] / sums[1]).to(field.device, field.dtype)


# --------------------------------------------------------------------------
# the shards of one process
# --------------------------------------------------------------------------


class LocalMesh:
    """The (face, y, x) shards of one process, all on one device: the
    counterpart of the JAX package's Mesh over a process's local devices,
    whose ``shard_map`` runs one program a device in one dispatch.

    Shard d is rank d of a (face_shards, y_shards, x_shards) mesh of
    ``CubedSphereMesh`` order (``shards[d]``, whose ``face_comm`` is the
    shard's ``LocalComm``), so code written for a process rank runs on a
    shard unchanged.  ``map(fn, device)`` runs ``fn(d)`` for every shard
    at once, one thread a shard (module docstring of
    ``halo_spmd.LocalComm`` for the exchanges between them); a shard
    waits at most ``timeout_s`` for its turn.  ``thread_context`` (a
    callable giving a context manager) is entered in every shard's
    thread, inside the rest; ``launches`` holds each shard's kernel
    launches in the last ``map`` (wrapper name -> count)."""

    def __init__(self, face_shards: int = 6, y_shards: int = 1,
                 x_shards: int = 1, timeout_s: float = LOCAL_TIMEOUT_S):
        self.face_shards, self.y_shards = face_shards, y_shards
        self.x_shards = x_shards
        self.timeout_s = timeout_s
        self.hub = LocalHub(self.n_devices, timeout_s)
        self.shards = []
        for d in range(self.n_devices):
            csm = CubedSphereMesh(face_shards, 1, y_shards, x_shards, rank=d)
            csm._comms["plane"] = LocalComm(self.hub, d)
            self.shards.append(csm)
        self.thread_context: Callable = contextlib.nullcontext
        self.launches: List[dict] = []
        self._streams = {}

    @property
    def n_devices(self) -> int:
        return self.face_shards * self.y_shards * self.x_shards

    def coords(self, d: int):
        """(face shard, tile row, tile column, 0) of shard d."""
        return self.shards[d].coords()

    def comm(self, d: int) -> LocalComm:
        return self.shards[d].face_comm

    def comms(self) -> Sequence[LocalComm]:
        return [self.comm(d) for d in range(self.n_devices)]

    def streams(self, device) -> Sequence["torch.cuda.Stream"]:
        """The shards' streams on a CUDA device, made once (before any
        capture that forks them)."""
        if device not in self._streams:
            self._streams[device] = [torch.cuda.Stream(device)
                                     for _ in range(self.n_devices)]
        return self._streams[device]

    def map(self, fn: Callable, device=None) -> list:
        """[fn(0), ..., fn(D - 1)], each fn(d) on a thread of its own, the
        threads taking turns between exchanges (``halo_spmd.LocalHub``),
        and, on a CUDA `device`, on shard d's stream, forked from the
        caller's current stream and joined back to it (in a capture: one
        branch of the graph a shard).

        Every thread runs under the caller's grad mode and with
        ``torch.autograd.set_multithreading_enabled(False)``: a backward
        runs in the thread that asks for it, and not on autograd's one
        worker thread of the card, where a shard's backward exchange
        would wait for its peers' behind it.  An exception in one shard
        breaks the hub, so the others raise at their next exchange, and
        the first shard's own exception is raised here; a shard that
        waits longer than ``timeout_s`` for its turn raises
        TimeoutError."""
        D = self.n_devices
        self.hub.reset()
        dev = None if device is None else torch.device(device)
        cuda = dev is not None and dev.type == "cuda"
        if cuda:
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            caller = torch.cuda.current_stream(dev)
            streams = self.streams(dev)
            for s in streams:
                s.wait_stream(caller)
        grad = torch.is_grad_enabled()
        results, errors, counts = [None] * D, [None] * D, [None] * D

        def body(d):
            try:
                self.hub.start(d)
                with contextlib.ExitStack() as stack:
                    stack.enter_context(
                        torch.autograd.set_multithreading_enabled(False))
                    stack.enter_context(torch.set_grad_enabled(grad))
                    if cuda:
                        stack.enter_context(torch.cuda.device(dev))
                        stack.enter_context(torch.cuda.stream(streams[d]))
                    counts[d] = stack.enter_context(_build.tally())
                    stack.enter_context(self.thread_context())
                    results[d] = fn(d)
            except BaseException as e:  # noqa: B036 -- re-raised by map
                errors[d] = e
                self.hub.abort()
            finally:
                self.hub.finish(d)

        threads = [threading.Thread(target=body, args=(d,),
                                    name=f"shard {d}", daemon=True)
                   for d in range(D)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if cuda:
            for s in streams:
                caller.wait_stream(s)
            for t in _tensors(results):
                t.record_stream(caller)
        self.launches = counts
        own = [e for e in errors if e is not None
               and not isinstance(e, threading.BrokenBarrierError)]
        if own:
            raise own[0]
        broken = [e for e in errors if e is not None]
        if broken:
            raise TimeoutError(
                f"a shard waited more than {self.timeout_s} s for its "
                "peers at an exchange") from broken[0]
        return results


def make_local_mesh(layout: Tuple[int, int, int] = (6, 1, 1),
                    timeout_s: float = LOCAL_TIMEOUT_S) -> LocalMesh:
    """The local mesh of `layout` (face shards, tile rows, tile columns):
    (6, 1, 1) the face mesh, one face a shard; (F, Y, X) a tiled mesh of
    parallel/tiling.py, 6/F faces' (y, x) tile a shard."""
    F, Y, X = layout
    if 6 % F:
        raise ValueError(f"the face axis {F} does not divide 6")
    return LocalMesh(F, Y, X, timeout_s)
