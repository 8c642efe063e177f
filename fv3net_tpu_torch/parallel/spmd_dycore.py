"""The multi-rank dycore: one face (or tiles of faces) per rank or shard,
halo exchanges over a mesh.

Counterpart of the JAX package's ``parallel/spmd_dycore.py``.  The
numerical step is the SAME code as the single-process path --
``hydro.build_one_dt`` -- run on every shard with (a) the SWMetrics
tensors sliced to the shard's faces or tile and (b) ``grid.halo.
spmd_mode`` switching every halo exchange (scalar, D-grid, C-grid,
boundary canonicalisation and averaging, the one-cell extension) to its
shard-local form (parallel/halo_spmd.py, parallel/tiling.py).  The
dampers built as M^T(W M) with ``torch.func.vjp`` stay exact transposes
because the exchanges' backward is their exact transpose.  The kernels
run inside each shard at shard shapes; the del-4 filter takes the
exchanged pair (``ops/cuda_filter.del4_filter_pair_cuda``) on the face
mesh and its plain form on tiles.

The reference scales by 6*x*y MPI ranks with FMS halo updates
(runtime/segmented_run/run.py:34-35): ``make_spmd_dycore_stepper`` is the
6-way face mesh, ``make_tiled_spmd_dycore_stepper`` the (face=F, y=Y,
x=X) mesh of parallel/tiling.py.  Both take either kind of mesh:

- a ``mesh.LocalMesh``: the JAX package's form, ``jax.jit(shard_map(...))``
  over a process's local devices.  One process steps every shard, each
  on a thread of its own and, on the card, a stream of its own, the
  exchanges device tensors handed between them (``halo_spmd.LocalComm``).
  On CUDA tensors ``run`` replays one CUDA graph of one dt of every shard
  (``graphs.Graphed``, one branch a shard), nsteps times; on the CPU it
  is the eager threaded loop.  ``shard`` and ``gather`` stay on the
  device;
- a ``mesh.CubedSphereMesh``: this process is one rank of a process
  group (multihost.py), stepping its own shard.  Every exchange is staged
  through the host over gloo, which a CUDA graph cannot hold, so ``run``
  stays eager, and ``gather`` goes through the host.

Both take ``remat`` (each acoustic substep checkpointed, as
``build_one_dt`` does it).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch
import torch.distributed as dist

from .. import graphs
from ..device import default_device
from ..dycore.hydro import DycoreState, build_one_dt, hybrid_coefficients
from ..dycore.sw import SWMetrics
from ..grid import halo as halo_mod
from ..grid.geometry import CubedSphereGrid
from .mesh import CubedSphereMesh, LocalMesh
from .tiling import TileLayout, tile_inv_corner_mult

Mesh = Union[CubedSphereMesh, LocalMesh]


def _slice_metrics(m: SWMetrics, faces: range) -> SWMetrics:
    """Slice every face-indexed metric tensor to the given faces."""
    updates = {}
    for f in dataclasses.fields(m):
        v = getattr(m, f.name)
        if isinstance(v, torch.Tensor) and v.ndim >= 1 and v.shape[0] == 6:
            updates[f.name] = v[faces.start : faces.stop]
    return dataclasses.replace(m, **updates)


def _one_dt_builder(m, nz, ptop, dtype, device, **kw):
    ak, bk = hybrid_coefficients(nz, ptop)
    ak = ak.to(dtype=dtype, device=device)
    bk = bk.to(dtype=dtype, device=device)
    return build_one_dt(
        m, ak, bk, nz, kw["dt_atmos"], kw["k_split"], kw["n_split"],
        kw["hord"], kw["kord"], kw["d2_damp"], ptop, dtype, kw["remat"],
    )


def _all_gather(x: torch.Tensor, mesh: CubedSphereMesh):
    """Every rank's x (same shapes), in rank order of the (face, y, x)
    plane, gathered through the host."""
    host = x.detach().to("cpu").contiguous()
    parts = [torch.empty_like(host) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, host)
    return [parts[r] for r in mesh._plane_ranks()]


def _local_run(mesh: LocalMesh, one_dts, tiling=None):
    """``run(sharded, phis, nsteps)`` of a local mesh: one dt of every
    shard is ``mesh.map`` of each shard's one_dt under its spmd_mode;
    on CUDA tensors a ``graphs.Graphed`` of it (carry: the shards'
    states), replayed nsteps times, its capture open to the shards'
    threads (``capture_error_mode="thread_local"``: they allocate into
    the graph's pool while the caller's thread holds the capture)."""
    comms = mesh.comms()

    def one_dt(sharded, phis):
        def shard_dt(d):
            with halo_mod.spmd_mode(comms[d], tiling=tiling):
                return one_dts[d](sharded[d], phis[d])

        return tuple(mesh.map(shard_dt, sharded[0].delp.device))

    graphed = graphs.Graphed(one_dt, carry="all",
                             capture_error_mode="thread_local")

    def run(sharded, phis, nsteps: int):
        sharded, phis = tuple(sharded), tuple(phis)
        if sharded[0].delp.device.type == graphs.CAPTURED_DEVICE:
            return graphed(sharded, phis, steps=nsteps)
        for _ in range(nsteps):
            sharded = one_dt(sharded, phis)
        return sharded

    run.one_dt = one_dt
    run.graphed = graphed
    return run


def _face_axis(name):
    return 1 if name == "q" else 0


def _faces_of(parts):
    """The full state from every face shard's DycoreState (face order):
    each field concatenated on its face axis."""
    return DycoreState(*[
        None if xs[0] is None else torch.cat(xs, dim=_face_axis(name))
        for name, xs in zip(DycoreState._fields, zip(*parts))
    ])


def make_spmd_dycore_stepper(
    g: CubedSphereGrid,
    nz: int,
    mesh: Mesh,
    dt_atmos: float,
    k_split: int = 1,
    n_split: int = 6,
    hord: int = 5,
    kord: int = 9,
    d2_damp: float = 0.12,
    ptop: float = 300.0,
    dtype=torch.float32,
    remat: bool = False,
    device=None,
):
    """The multi-rank dycore step over a 6-way face mesh (one face a
    shard; level shards of a process group, if any, repeat the step).

    Returns (run, shard, gather), on `device` (the CUDA device unless the
    caller names one).  On a LocalMesh: ``shard(state, phis)`` is every
    shard's slice of a full state ([1, nz, ...] fields, q [ntracer, 1,
    ...], phis [1, n, n]: a tuple of six DycoreStates and a tuple of six
    phis); ``run(sharded, phis, nsteps)`` steps them all (one replayed
    graph a dt on CUDA); ``gather(sharded)`` rebuilds the full state on
    the device.  On a CubedSphereMesh (a process rank): ``shard`` is
    this rank's slice, ``run`` steps it, and ``gather`` rebuilds the full
    state on every rank (through the host).
    """
    if mesh.face_shards != 6 or mesh.y_shards * mesh.x_shards != 1:
        raise ValueError("spmd dycore needs a 6-way face mesh")
    if device is None:
        device = default_device("make_spmd_dycore_stepper")
    m = SWMetrics.make(g, dtype, device=device)

    def face_dt(f):
        return _one_dt_builder(
            _slice_metrics(m, range(f, f + 1)), nz, ptop, dtype, device,
            dt_atmos=dt_atmos, k_split=k_split, n_split=n_split, hord=hord,
            kord=kord, d2_damp=d2_damp, remat=remat,
        )

    def put(x, f, axis=0):
        if x is None:
            return None
        return x.narrow(axis, f, 1).to(device).contiguous()

    def shard_of(state, phis, f):
        return DycoreState(*[
            put(x, f, _face_axis(name))
            for name, x in zip(DycoreState._fields, state)
        ]), put(phis, f)

    if isinstance(mesh, LocalMesh):
        run = _local_run(mesh, [face_dt(f) for f in range(6)])

        def shard(state: DycoreState, phis):
            parts = [shard_of(state, phis, f) for f in range(6)]
            return tuple(p[0] for p in parts), tuple(p[1] for p in parts)

        def gather(sharded):
            return _faces_of(sharded)

        return run, shard, gather

    f = mesh.coords()[0]
    one_dt = face_dt(f)
    comm = mesh.face_comm

    def run(state: DycoreState, phis, nsteps: int):
        with halo_mod.spmd_mode(comm):
            for _ in range(nsteps):
                state = one_dt(state, phis)
        return state

    def shard(state: DycoreState, phis):
        return shard_of(state, phis, f)

    def gather(state: DycoreState):
        parts = zip(*[
            [None] * 6 if x is None else _all_gather(x, mesh)
            for x in state
        ])
        out = _faces_of([DycoreState(*p) for p in parts])
        return DycoreState(*[
            None if x is None else x.to(ref.device)
            for x, ref in zip(out, state)
        ])

    run.one_dt = one_dt
    run.comm = comm
    return run, shard, gather


# --------------------------------------------------------------------------
# Within-face (x, y) tiled dycore (parallel/tiling.py)
# --------------------------------------------------------------------------
# Cell-centred fields shard natively over (face, y, x); staggered winds are
# carried in BLOCKED layout (each tile stores one redundant top row / right
# column, refreshed from its canonical owner by every exchange, see
# tiling.py).  The numerical step is the same build_one_dt, with per-tile
# metrics and the face-edge/vertex treatments gated by the tile's position.

_PAD_XY = (
    "area_px", "area_py", "f_px", "f_py", "dxc_f", "dyc_f", "dy_f",
    "dx_f", "dy_fs", "dx_fs", "cosa_u", "rsin2_u", "cosa_v", "rsin2_v",
    "sina_u", "sina_v",
)
_INT_XY = ("rarea", "f_center", "cosa_c", "rsin2_c")
_BW_ROWS = ("xbw_w", "xbw_e")
_BW_COLS = ("ybw_s", "ybw_n")


def _slice_metrics_tiled(m: SWMetrics, lay: TileLayout, a: int, b: int,
                         c: int) -> SWMetrics:
    """Slice every metric tensor to tile (a, b, c)'s windows.  A layout of
    whole faces (Y = X = 1) keeps the face-level path (edge flags None):
    every tile edge is a face edge there."""
    L, nl, h = lay.L, lay.nl, m.halo
    Nt = nl + 2 * h
    fa, rb, cc = a * L, b * nl, c * nl
    fs = slice(fa, fa + L)
    up = {}
    for name in _PAD_XY:
        up[name] = getattr(m, name)[fs, rb : rb + Nt, cc : cc + Nt]
    for name in _INT_XY:
        up[name] = getattr(m, name)[fs, rb : rb + nl, cc : cc + nl]
    up["dx_u"] = m.dx_u[fs, rb : rb + Nt + 1, cc : cc + Nt]
    up["dy_v"] = m.dy_v[fs, rb : rb + Nt, cc : cc + Nt + 1]
    up["cosa_b"] = m.cosa_b[fs, rb : rb + Nt + 1, cc : cc + Nt + 1]
    up["rsin2_b"] = m.rsin2_b[fs, rb : rb + Nt + 1, cc : cc + Nt + 1]
    up["area_c_int"] = m.area_c_int[fs, rb : rb + nl + 1, cc : cc + nl + 1]
    for name in _BW_ROWS:
        up[name] = getattr(m, name)[fs, rb : rb + nl]
    for name in _BW_COLS:
        up[name] = getattr(m, name)[fs, cc : cc + nl]
    if lay.Y * lay.X > 1:
        icm = tile_inv_corner_mult(lay)[b, c][None]
        up["inv_corner_mult"] = torch.as_tensor(
            icm, dtype=m.area_px.dtype, device=m.area_px.device
        )
        up["edge_w"] = c == 0
        up["edge_e"] = c == lay.X - 1
        up["edge_s"] = b == 0
        up["edge_n"] = b == lay.Y - 1
    up = {k: (v.contiguous() if isinstance(v, torch.Tensor) else v)
          for k, v in up.items()}
    return dataclasses.replace(m, n=nl, **up)


def block_winds(u, v, lay: TileLayout):
    """[6, nz, n+1, n], [6, nz, n, n+1] -> blocked
    [6, Y, X, nz, nl+1, nl], [6, Y, X, nz, nl, nl+1]."""
    nl = lay.nl
    ub = torch.stack([
        torch.stack([
            u[:, :, b * nl : b * nl + nl + 1, c * nl : (c + 1) * nl]
            for c in range(lay.X)
        ], dim=1)
        for b in range(lay.Y)
    ], dim=1)
    vb = torch.stack([
        torch.stack([
            v[:, :, b * nl : (b + 1) * nl, c * nl : c * nl + nl + 1]
            for c in range(lay.X)
        ], dim=1)
        for b in range(lay.Y)
    ], dim=1)
    return ub, vb


def unblock_winds(ub, vb, lay: TileLayout):
    """Inverse of block_winds, reading every slot from its canonical
    owner (interior shared rows/cols from the tile whose block starts
    there; the face's own n-th row/col from the last tile)."""
    nl = lay.nl
    rows = [ub[:, b, :, :, :nl] for b in range(lay.Y)]
    rows.append(ub[:, lay.Y - 1, :, :, nl:])
    u = torch.cat(
        [torch.cat([r[:, cidx] for cidx in range(lay.X)], dim=-1)
         for r in rows],
        dim=-2,
    )
    cols = [vb[:, :, cidx, :, :, :nl] for cidx in range(lay.X)]
    cols.append(vb[:, :, lay.X - 1, :, :, nl:])
    v = torch.cat(
        [torch.cat([cpart[:, b] for b in range(lay.Y)], dim=-2)
         for cpart in cols],
        dim=-1,
    )
    return u, v


def _tiles_of(parts, lay: TileLayout):
    """The full state from every tile's DycoreState ((face, y, x) order,
    blocked winds), on the tiles' device."""
    L, nl = lay.L, lay.nl

    def place(d):
        a, rest = divmod(d, lay.Y * lay.X)
        return (a,) + divmod(rest, lay.X)

    def cells(xs, lead=0):
        if xs[0] is None:
            return None
        shape = list(xs[0].shape)
        shape[lead] = 6
        shape[-2] = shape[-1] = lay.n
        out = xs[0].new_empty(shape)
        for d, x in enumerate(xs):
            a, b, c = place(d)
            idx = [slice(None)] * len(shape)
            idx[lead] = slice(a * L, (a + 1) * L)
            idx[-2] = slice(b * nl, (b + 1) * nl)
            idx[-1] = slice(c * nl, (c + 1) * nl)
            out[tuple(idx)] = x
        return out

    def blocked(xs):
        out = xs[0].new_empty((6, lay.Y, lay.X) + tuple(xs[0].shape[1:]))
        for d, x in enumerate(xs):
            a, b, c = place(d)
            out[a * L : (a + 1) * L, b, c] = x
        return out

    fields = dict(zip(DycoreState._fields, zip(*parts)))
    u, v = unblock_winds(blocked(fields["u"]), blocked(fields["v"]), lay)
    return DycoreState(
        delp=cells(fields["delp"]), pt=cells(fields["pt"]), u=u, v=v,
        q=cells(fields["q"], lead=1), w=cells(fields["w"]),
        delz=cells(fields["delz"]),
    )


def make_tiled_spmd_dycore_stepper(
    g: CubedSphereGrid,
    nz: int,
    mesh: Mesh,
    lay: TileLayout,
    dt_atmos: float,
    k_split: int = 1,
    n_split: int = 6,
    hord: int = 5,
    kord: int = 9,
    d2_damp: float = 0.12,
    ptop: float = 300.0,
    dtype=torch.float32,
    remat: bool = False,
    device=None,
):
    """The (face, y, x)-tiled multi-rank dycore step.

    Returns (run, shard, gather), on `device` (the CUDA device unless the
    caller names one).  A tile's state: cells [L, nz, nl, nl], blocked
    winds u [L, nz, nl+1, nl] and v [L, nz, nl, nl+1] (``block_winds``),
    q [ntracer, L, ...], phis [L, nl, nl].  On a LocalMesh: ``shard``
    cuts every tile from a full state (tuples in (face, y, x) order),
    ``run(sharded, phis, nsteps)`` steps them all (one replayed graph a
    dt on CUDA), ``gather`` rebuilds the full state on the device
    (``unblock_winds``).  On a CubedSphereMesh (a process rank):
    ``shard`` cuts this rank's tile, ``run`` steps it, ``gather``
    rebuilds the full state on every rank (through the host).
    """
    if (mesh.face_shards, mesh.y_shards, mesh.x_shards) != (
        lay.F, lay.Y, lay.X
    ):
        raise ValueError(f"mesh {mesh} does not match layout {lay}")
    if g.n != lay.n or g.halo != lay.h:
        raise ValueError("grid/layout mismatch")
    if device is None:
        device = default_device("make_tiled_spmd_dycore_stepper")
    m = SWMetrics.make(g, dtype, device=device)
    L, nl = lay.L, lay.nl

    def tile_dt(d):
        a, b, c, _ = mesh.coords(d)
        return _one_dt_builder(
            _slice_metrics_tiled(m, lay, a, b, c), nz, ptop, dtype, device,
            dt_atmos=dt_atmos, k_split=k_split, n_split=n_split, hord=hord,
            kord=kord, d2_damp=d2_damp, remat=remat,
        )

    def put(x):
        return None if x is None else x.to(device).contiguous()

    def shard_of(state, ub, vb, phis, coords):
        a, b, c, _ = coords
        fs = slice(a * L, (a + 1) * L)
        ys, xs = slice(b * nl, (b + 1) * nl), slice(c * nl, (c + 1) * nl)

        def cells(x, lead=0):
            if x is None:
                return None
            return put(x[(slice(None),) * lead + (fs, slice(None), ys, xs)])

        return DycoreState(
            delp=cells(state.delp), pt=cells(state.pt),
            u=put(ub[fs, b, c]), v=put(vb[fs, b, c]),
            q=cells(state.q, lead=1), w=cells(state.w),
            delz=cells(state.delz),
        ), put(phis[fs, ys, xs])

    if isinstance(mesh, LocalMesh):
        run = _local_run(mesh, [tile_dt(d) for d in range(lay.D)],
                         tiling=lay)

        def shard(state: DycoreState, phis):
            ub, vb = block_winds(state.u, state.v, lay)
            parts = [shard_of(state, ub, vb, phis, mesh.coords(d))
                     for d in range(lay.D)]
            return tuple(p[0] for p in parts), tuple(p[1] for p in parts)

        def gather(sharded):
            return _tiles_of(sharded, lay)

        return run, shard, gather

    one_dt = tile_dt(mesh.rank)
    comm = mesh.face_comm

    def run(state: DycoreState, phis, nsteps: int):
        with halo_mod.spmd_mode(comm, tiling=lay):
            for _ in range(nsteps):
                state = one_dt(state, phis)
        return state

    def shard(state: DycoreState, phis):
        ub, vb = block_winds(state.u, state.v, lay)
        return shard_of(state, ub, vb, phis, mesh.coords())

    def gather(state: DycoreState):
        parts = zip(*[
            [None] * lay.D if x is None else _all_gather(x, mesh)
            for x in state
        ])
        out = _tiles_of([DycoreState(*p) for p in parts], lay)
        return DycoreState(*[
            None if x is None else x.to(ref.device)
            for x, ref in zip(out, state)
        ])

    run.one_dt = one_dt
    run.comm = comm
    return run, shard, gather
