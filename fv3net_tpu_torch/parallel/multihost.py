"""Multi-process runtime: the mpirun replacement.

Counterpart of the JAX package's ``parallel/multihost.py``.  The
reference launches one OS process per rank with
``mpirun -n 6*x*y python -m mpi4py runtime/main.py``
(workflows/prognostic_c48_run/runtime/segmented_run/run.py:36-50).  Here
each process joins one ``torch.distributed`` process group
(``initialize``) and holds the faces or tiles of its rank
(``global_face_mesh``, ``make_global_array``, ``process_local_faces``);
``spawn`` starts such a group of processes on one machine and checks
every rank's exit code.

Which transport goes where:
- several shards of one process share a card through device tensors
  (``mesh.LocalMesh``, ``halo_spmd.LocalComm``): no process group, and
  the dycore's ``run`` is one replayed CUDA graph a dt
  (parallel/spmd_dycore.py).  The JAX package's own form;
- process ranks with a card each: NCCL (``initialize`` picks it when
  there are at least as many cards as ranks); eager, payloads on the
  device.  Not run on a one-card machine;
- process ranks without a card of their own (CPU ranks, or several ranks
  sharing one card: NCCL refuses two ranks of one communicator on the
  same device): gloo, eager, each exchange staged through the host
  (parallel/halo_spmd.py ``Comm``).
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import CubedSphereMesh

DEFAULT_TIMEOUT_S = 300.0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: Optional[float] = None,
) -> Tuple[int, int]:
    """Join (or create) the process group; returns (process_id,
    num_processes).

    Arguments default from the environment: ``FV3_COORDINATOR_ADDRESS``
    (an init method, ``tcp://host:port`` or ``file:///path``),
    ``WORLD_SIZE``, ``RANK`` and ``FV3_DIST_TIMEOUT`` (seconds; every
    collective and exchange fails after it).  Single-process when nothing
    is configured.  With CUDA, a rank uses card ``rank % device_count``;
    the backend is NCCL when there are at least as many cards as ranks,
    gloo otherwise.
    """
    env = os.environ
    coordinator_address = coordinator_address or env.get(
        "FV3_COORDINATOR_ADDRESS"
    )
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    if coordinator_address is None or num_processes <= 1:
        return 0, 1
    if timeout_s is None:
        timeout_s = float(env.get("FV3_DIST_TIMEOUT", DEFAULT_TIMEOUT_S))
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    backend = (
        "nccl" if cuda and torch.cuda.device_count() >= num_processes
        else "gloo"
    )
    dist.init_process_group(
        backend, init_method=coordinator_address,
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return process_id, num_processes


def global_face_mesh(
    layout: Optional[Sequence[int]] = None,
) -> CubedSphereMesh:
    """A (face[, y, x]) mesh over every rank of the process group.

    layout: within-face (y, x) tiling; defaults to (1, 1) (6 ranks,
    face-only: the reference's layout=[1,1] 6-rank configuration).
    The group's size must equal 6*y*x; rank order groups whole faces
    (or contiguous tile blocks)."""
    y, x = tuple(layout) if layout is not None else (1, 1)
    rank, world = dist.get_rank(), dist.get_world_size()
    need = 6 * y * x
    if world != need:
        raise ValueError(
            f"global_face_mesh(layout={(y, x)}) needs {need} ranks, "
            f"got {world}"
        )
    return CubedSphereMesh(6, 1, y, x, rank=rank)


def _blocks(shape, mesh: CubedSphereMesh, spec):
    """The slices of this rank's block of an array of `shape` split by
    `spec`: one mesh axis name ("face", "y", "x", "z") or None per
    dimension."""
    f, y, x, z = mesh.coords()
    index = {"face": (f, mesh.face_shards), "y": (y, mesh.y_shards),
             "x": (x, mesh.x_shards), "z": (z, mesh.z_shards)}
    out = []
    for size, name in zip(shape, tuple(spec) + (None,) * len(shape)):
        if name is None:
            out.append(slice(None))
            continue
        i, k = index[name]
        if size % k:
            raise ValueError(f"axis of {size} does not split over {k}")
        b = size // k
        out.append(slice(i * b, (i + 1) * b))
    return tuple(out)


def make_global_array(host_value, mesh: CubedSphereMesh, spec,
                      device=None) -> torch.Tensor:
    """This rank's block of a host-replicated value (every process holds
    the full field, as after reading a restart; the runtime equivalent of
    pace.util scatter, runtime/scatter.py:11), as a tensor on `device`
    (the CUDA device unless the caller names one).  spec: one mesh axis
    name or None per dimension, e.g. ("face", None, None, None)."""
    from ..device import default_device

    if device is None:
        device = default_device("make_global_array")
    host_value = np.asarray(host_value)
    block = host_value[_blocks(host_value.shape, mesh, spec)]
    return torch.as_tensor(np.ascontiguousarray(block), device=device)


def process_local_faces(mesh: CubedSphereMesh) -> Sequence[int]:
    """Which face indices this process owns (for per-rank IO)."""
    return list(mesh.faces)


class Ranks:
    """A group of rank processes started by ``spawn``."""

    def __init__(self, procs, paths, timeout_s):
        self.procs, self.paths = procs, paths
        self.deadline = time.monotonic() + timeout_s

    def kill(self):
        """Kill the ranks still running."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def wait(self):
        """Wait for every rank; raise as soon as one fails, or at the
        deadline, after killing the others.  Returns the logs' texts."""
        failed = []
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                failed = [(r, c) for r, c in enumerate(codes)
                          if c not in (None, 0)]
                if failed or all(c == 0 for c in codes):
                    break
                if time.monotonic() > self.deadline:
                    failed = [(r, "timeout") for r, c in enumerate(codes)
                              if c is None]
                    break
                time.sleep(0.05)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = [open(path).read() for path in self.paths]
        if failed:
            raise RuntimeError("ranks failed:\n" + "\n".join(
                f"rank {r} ({why}):\n{texts[r][-3000:]}"
                for r, why in failed
            ))
        return texts


def spawn(argv: Sequence[str], nprocs: int, store_path: str,
          timeout_s: float = 900.0, env: Optional[dict] = None) -> Ranks:
    """Start `nprocs` processes ``python argv...`` as the ranks of one
    process group: RANK, WORLD_SIZE and a FileStore init method at
    `store_path` in their environment (initialize reads them).  Each
    rank writes to ``rank<r>.log`` in store_path's directory.  Returns
    at once; ``.wait()`` checks every rank's exit code."""
    if os.path.exists(store_path):
        os.remove(store_path)
    log_dir = os.path.dirname(os.path.abspath(store_path))
    procs, paths = [], []
    for r in range(nprocs):
        e = dict(os.environ if env is None else env)
        e.update(RANK=str(r), WORLD_SIZE=str(nprocs),
                 FV3_COORDINATOR_ADDRESS=f"file://{store_path}")
        path = os.path.join(log_dir, f"rank{r}.log")
        paths.append(path)
        with open(path, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, *argv], env=e, stdout=out,
                stderr=subprocess.STDOUT,
            ))
    return Ranks(procs, paths, timeout_s)
