"""Within-face (x, y) domain decomposition for the cubed-sphere dycore.

Counterpart of the JAX package's ``parallel/tiling.py``.  The reference
scales by ``6*x*y`` MPI ranks -- 6 faces times a ``layout=[x, y]``
within-face tiling (pace.util CubedSpherePartitioner).  Here a process
group is laid out as ``(face=F, y=Y, x=X)``: every rank owns ``6/F``
faces' worth of one ``(y, x)`` tile, and every halo/staggered exchange
runs as a compressed plan over the ranks.

The tables are the JAX package's host numpy, copied: every face-level
exchange is a static table ``output slot -> (source face, face-local
pool index, sign)``, and the tiled tables are derived from it --

  1. OUTPUT side: slice the face-level table to the tile's padded
     window (tile rows ``[b*nl, b*nl + nl + 2h (+1)]`` in face-padded
     coordinates);
  2. SOURCE side: re-encode each face-level source ``(face, j, i)``
     through the CANONICAL OWNERSHIP map: staggered arrays are stored
     per tile with one redundant top row / right column
     (u: ``[nl+1, nl]``, v: ``[nl, nl+1]``), and the canonical owner of
     a shared row/column is the tile whose block starts there, so ghost
     copies are refreshed from their owner by every exchange.

``build_compressed_plan`` packs each (sender, receiver) pair's slots;
``apply_plan_numpy`` is the reference executor.  ``apply_plan`` runs a
plan over the process group as one message per (sender, receiver) pair
(``halo_spmd.RankExchange``: isend/irecv, staged through the host under
gloo) and one gather; its backward is the inverse messages and the
gather-form transpose.  For every exchange the tiled output equals the
face-level padded output sliced to the tile's window, bit for bit, which
is what lets ``build_one_dt`` run unchanged on a tile.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from .halo_spmd import COMMS, Comm, RankExchange, Tables, run_exchange


# --------------------------------------------------------------------------
# Layout
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TileLayout:
    """``(face=F, y=Y, x=X)`` mesh layout over the cube.

    F divides 6 (each device owns L = 6/F whole faces' tiles); Y == X
    (square tiles -- the dycore kernels assume square local arrays) and
    n % Y == 0.
    """

    n: int  # face extent
    h: int  # halo width
    F: int
    Y: int
    X: int

    def __post_init__(self):
        if 6 % self.F != 0:
            raise ValueError("face axis must divide 6")
        if self.Y != self.X:
            raise ValueError("square tiles required (Y == X)")
        if self.n % self.Y != 0 or self.n % self.X != 0:
            raise ValueError("n must be divisible by the layout")
        if self.nl < self.h:
            raise ValueError(
                f"tile extent {self.nl} smaller than halo {self.h}"
            )

    @property
    def L(self) -> int:  # faces per device
        return 6 // self.F

    @property
    def nl(self) -> int:  # tile extent
        return self.n // self.Y

    @property
    def D(self) -> int:  # device count
        return self.F * self.Y * self.X

    def device_of(self, g, b, c):
        """(face, tile-row, tile-col) -> flat device index."""
        return (g // self.L) * self.Y * self.X + b * self.X + c


# --------------------------------------------------------------------------
# Compressed exchange plans
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Round:
    perm: Tuple[Tuple[int, int], ...]
    tbl: np.ndarray  # [D, P] SENDER-side gather indices into local pool
    sign: np.ndarray  # [D, P]


@dataclasses.dataclass(frozen=True)
class CompressedPlan:
    """output[slot] = sign * pool_{src_device}[src_loc], executed as
    local gathers + payload-packed ppermute rounds + one final gather."""

    out_shape: Tuple[int, ...]
    local_tbl: np.ndarray  # [D, P0]
    local_sign: np.ndarray
    rounds: Tuple[_Round, ...]
    final_map: np.ndarray  # [D, out_size] into [zero | local | rounds]

    @property
    def n_devices(self):
        return self.final_map.shape[0]


def build_compressed_plan(src_dev, src_loc, sign) -> CompressedPlan:
    """src_dev/src_loc/sign: [D, *out_shape]; sign == 0 marks slots with
    no source (output 0)."""
    D = src_dev.shape[0]
    out_shape = src_dev.shape[1:]
    S = int(np.prod(out_shape))
    sr = np.asarray(src_dev).reshape(D, S)
    sl = np.asarray(src_loc).reshape(D, S)
    sg = np.asarray(sign, np.float64).reshape(D, S)
    final = np.zeros((D, S), np.int64)

    # local contributions
    local_slots = []
    for d in range(D):
        local_slots.append(np.nonzero((sr[d] == d) & (sg[d] != 0))[0])
    P0 = max((len(s) for s in local_slots), default=0) or 1
    local_tbl = np.zeros((D, P0), np.int32)
    local_sign = np.zeros((D, P0))
    for d in range(D):
        s = local_slots[d]
        k = len(s)
        local_tbl[d, :k] = sl[d, s]
        local_sign[d, :k] = sg[d, s]
        final[d, s] = 1 + np.arange(k)

    # remote (sender, receiver) pairs
    pairs = {}
    for d in range(D):
        remote = (sr[d] != d) & (sg[d] != 0)
        for g in np.unique(sr[d][remote]):
            pairs[(int(g), d)] = np.nonzero(remote & (sr[d] == g))[0]

    offset = 1 + P0
    rounds = []
    rem = dict(pairs)
    while rem:
        used_s, used_r, batch = set(), set(), {}
        for (g, d) in list(rem):
            if g in used_s or d in used_r:
                continue
            used_s.add(g)
            used_r.add(d)
            batch[(g, d)] = rem.pop((g, d))
        P = max(len(s) for s in batch.values())
        tbl = np.zeros((D, P), np.int32)
        sgn = np.zeros((D, P))
        perm = []
        for (g, d), slots in batch.items():
            k = len(slots)
            tbl[g, :k] = sl[d, slots]
            sgn[g, :k] = sg[d, slots]
            final[d, slots] = offset + np.arange(k)
            perm.append((g, d))
        rounds.append(_Round(tuple(perm), tbl, sgn))
        offset += P
    return CompressedPlan(
        tuple(int(x) for x in out_shape),
        local_tbl,
        local_sign,
        tuple(rounds),
        final.astype(np.int32),
    )


def compressed_plan_tables(plan: CompressedPlan) -> Tables:
    """The global tables (source device, pool index, sign) of a
    compressed plan."""
    D, S = plan.final_map.shape
    fm = plan.final_map.astype(np.int64)
    src = np.full((D, S), -1, np.int64)
    loc = np.zeros((D, S), np.int64)
    sign = np.zeros((D, S))
    P0 = plan.local_tbl.shape[1]
    rows = np.arange(D)[:, None] * np.ones((1, S), np.int64)
    own = (fm >= 1) & (fm <= P0)
    src[own] = rows[own]
    loc[own] = plan.local_tbl[rows[own], fm[own] - 1]
    sign[own] = plan.local_sign[rows[own], fm[own] - 1]
    offset = 1 + P0
    for rnd in plan.rounds:
        P = rnd.tbl.shape[1]
        for g, d in rnd.perm:
            sel = (fm[d] >= offset) & (fm[d] < offset + P)
            k = fm[d, sel] - offset
            src[d, sel] = g
            loc[d, sel] = rnd.tbl[g, k]
            sign[d, sel] = rnd.sign[g, k]
        offset += P
    return Tables(tuple(plan.out_shape), src, loc, sign)


_RANK_EXCHANGES = {}


def _rank_exchange(plans, d: int, pool_size: int) -> RankExchange:
    # plans are cached by their builders (kept alive here), so their ids
    # name them
    key = (tuple(id(p) for p in plans), d, pool_size)
    if key not in _RANK_EXCHANGES:
        _RANK_EXCHANGES[key] = (plans, RankExchange(
            [compressed_plan_tables(p) for p in plans], d, pool_size
        ))
    return _RANK_EXCHANGES[key][1]


def _comm(comm, lay: "TileLayout"):
    if comm is None:
        from ..grid import halo as halo_mod

        comm = halo_mod.spmd_axis()
    if not isinstance(comm, COMMS) or comm.size != lay.D:
        raise ValueError(
            f"layout {lay} needs the Comm of its {lay.D} (face, y, x) ranks"
        )
    return comm


def apply_plans(plans, pool, comm: Comm):
    """Outputs of several plans that read one pool, over the process
    group (differentiable): pool [lead..., pool_size] this rank's values;
    returns [lead..., *plan.out_shape] for each plan."""
    rx = _rank_exchange(tuple(plans), comm.index, pool.shape[-1])
    return run_exchange(rx, pool, comm)


def apply_plan(plan: CompressedPlan, pool, comm: Comm):
    """pool: [lead..., pool_size] this rank's values; comm: the Comm of
    the plan's devices (device d = comm.ranks[d]).  Returns
    [lead..., *plan.out_shape]."""
    return apply_plans((plan,), pool, comm)[0]


def apply_plan_numpy(plan: CompressedPlan, pools):
    """Reference executor for tests: pools [D, lead..., pool_size] ->
    [D, lead..., *out_shape]."""
    pools = np.asarray(pools)
    D = plan.n_devices
    lead = pools.shape[1:-1]
    payloads = []
    for d in range(D):
        parts = [np.zeros(lead + (1,), pools.dtype)]
        parts.append(
            np.take(pools[d], plan.local_tbl[d], axis=-1)
            * plan.local_sign[d]
        )
        payloads.append(parts)
    for rnd in plan.rounds:
        sends = {
            s: np.take(pools[s], rnd.tbl[s], axis=-1) * rnd.sign[s]
            for s, _ in rnd.perm
        }
        P = rnd.tbl.shape[1]
        recv = [np.zeros(lead + (P,), pools.dtype) for _ in range(D)]
        for s, dst in rnd.perm:
            recv[dst] = sends[s]
        for d in range(D):
            payloads[d].append(recv[d])
    out = []
    for d in range(D):
        buf = np.concatenate(payloads[d], axis=-1)
        out.append(
            np.take(buf, plan.final_map[d], axis=-1).reshape(
                lead + plan.out_shape
            )
        )
    return np.stack(out)


# --------------------------------------------------------------------------
# Face-level table decode + canonical tiled ownership encode
# --------------------------------------------------------------------------
# Face-level pools (grid/halo.py):
#   scalar: [n*n] per face, loc = j*n + i
#   D-grid: u [n+1, n] then v [n, n+1]; u loc = J*n + i,
#           v loc = 6*(n+1)*n .. decoded at face level by halo_spmd
#   C-grid: uc [n, n+1] then vc [n+1, n]
# Tiled pools (per device, face-slot major):
#   scalar: L * nl*nl
#   D-grid: L * ((nl+1)*nl + nl*(nl+1)), u block first per face slot
#   C-grid: L * (nl*(nl+1) + (nl+1)*nl), uc block first


def _scalar_block(lay):
    return lay.nl * lay.nl


def _dgrid_block(lay):
    return (lay.nl + 1) * lay.nl + lay.nl * (lay.nl + 1)


def _cgrid_block(lay):
    return lay.nl * (lay.nl + 1) + (lay.nl + 1) * lay.nl


# Vectorized owner maps: face-pool loc arrays -> (oy, ox, tile-pool loc).
# Canonical ownership of shared staggered rows/cols: the tile whose block
# STARTS there (min(idx // nl, tiles - 1)); other tiles' copies are
# ghosts, refreshed from the canonical owner by every exchange.


def _scalar_owner_vec(lay: TileLayout, loc):
    n, nl = lay.n, lay.nl
    j, i = loc // n, loc % n
    oy, ox = j // nl, i // nl
    return oy, ox, (j % nl) * nl + (i % nl)


def _dgrid_owner_vec(lay: TileLayout, loc):
    n, nl = lay.n, lay.nl
    nu = (n + 1) * n
    bu = (nl + 1) * nl
    is_u = loc < nu
    # u part: (J in [0, n], i)
    J = loc // n
    i = loc % n
    oy_u = np.minimum(J // nl, lay.Y - 1)
    ox_u = i // nl
    loc_u = (J - oy_u * nl) * nl + (i % nl)
    # v part: (j, I in [0, n])
    r = loc - nu
    j = r // (n + 1)
    I = r % (n + 1)
    oy_v = j // nl
    ox_v = np.minimum(I // nl, lay.X - 1)
    loc_v = bu + (j % nl) * (nl + 1) + (I - ox_v * nl)
    return (
        np.where(is_u, oy_u, oy_v),
        np.where(is_u, ox_u, ox_v),
        np.where(is_u, loc_u, loc_v),
    )


def _cgrid_owner_vec(lay: TileLayout, loc):
    n, nl = lay.n, lay.nl
    nuc = n * (n + 1)
    buc = nl * (nl + 1)
    is_uc = loc < nuc
    # uc part: (j, I in [0, n])
    j = loc // (n + 1)
    I = loc % (n + 1)
    oy_u = j // nl
    ox_u = np.minimum(I // nl, lay.X - 1)
    loc_u = (j % nl) * (nl + 1) + (I - ox_u * nl)
    # vc part: (J in [0, n], i)
    r = loc - nuc
    J = r // n
    i = r % n
    oy_v = np.minimum(J // nl, lay.Y - 1)
    ox_v = i // nl
    loc_v = buc + (J - oy_v * nl) * nl + (i % nl)
    return (
        np.where(is_uc, oy_u, oy_v),
        np.where(is_uc, ox_u, ox_v),
        np.where(is_uc, loc_u, loc_v),
    )


# --------------------------------------------------------------------------
# Tiled table construction
# --------------------------------------------------------------------------


def _tile_tables(
    lay: TileLayout,
    face_src_face,  # [6, *face_out] source face per output slot
    face_src_loc,  # [6, *face_out] face-pool loc (kind-encoded)
    face_sign,  # [6, *face_out]
    owner_vec,  # (lay, loc array) -> (oy, ox, tile-pool loc) arrays
    block,  # per-face-slot tile pool block size
    window,  # (b, c) -> tuple of slices into face_out
    tile_out_shape,  # per-face-slot tile output shape
):
    """Generic face-table -> device-table derivation (steps 1+2 of the
    module docstring), fully vectorized per tile window."""
    D, L = lay.D, lay.L
    out_shape = (L,) + tuple(tile_out_shape)
    src_dev = np.zeros((D,) + out_shape, np.int32)
    src_loc = np.zeros((D,) + out_shape, np.int64)
    sign = np.zeros((D,) + out_shape, np.float64)
    face_src_face = np.asarray(face_src_face, np.int64)
    face_src_loc = np.asarray(face_src_loc, np.int64)
    face_sign = np.asarray(face_sign, np.float64)
    for a in range(lay.F):
        for b in range(lay.Y):
            for c in range(lay.X):
                d = a * lay.Y * lay.X + b * lay.X + c
                win = (slice(a * L, (a + 1) * L),) + window(b, c)
                sf = face_src_face[win]
                sl = face_src_loc[win]
                sg = face_sign[win]
                oy, ox, loc = owner_vec(lay, sl)
                dd = (sf // L) * lay.Y * lay.X + oy * lay.X + ox
                dloc = (sf % L) * block + loc
                live = sg != 0
                src_dev[d] = np.where(live, dd, 0)
                src_loc[d] = np.where(live, dloc, 0)
                sign[d] = sg
    return src_dev, src_loc, sign


# ---- scalar halo ----------------------------------------------------------


@lru_cache(maxsize=None)
def scalar_halo_plan(lay: TileLayout, fill: str) -> CompressedPlan:
    from ..grid import topology as topo

    n, h = lay.n, lay.h
    if fill == "none":
        src_face, src_j, src_i, _ = topo.halo_source_indices(n, h)
    else:
        src_face, src_j, src_i, _ = topo.halo_source_indices_filled(
            n, h, fill
        )
    face_loc = src_j.astype(np.int64) * n + src_i
    sign = np.ones_like(face_loc, np.float64)
    nl, Nt = lay.nl, lay.nl + 2 * h

    def window(b, c):
        return (
            slice(b * nl, b * nl + Nt),
            slice(c * nl, c * nl + Nt),
        )

    sd, slc, sg = _tile_tables(
        lay, src_face, face_loc, sign,
        _scalar_owner_vec, _scalar_block(lay),
        window, (Nt, Nt),
    )
    return build_compressed_plan(sd, slc, sg)


# ---- D-grid ---------------------------------------------------------------


def _dgrid_face_tables(n, h):
    """Face-level D-grid tables re-encoded as (face, face-pool loc)."""
    from ..grid.halo import _dgrid_tables
    from .halo_spmd import _decode_pool

    (uf, us), (vf, vs) = _dgrid_tables(n, h)
    size_u, size_v = (n + 1) * n, n * (n + 1)
    gu, lu = _decode_pool(uf, size_u, size_v)
    gv, lv = _decode_pool(vf, size_u, size_v)
    return (gu, lu, us), (gv, lv, vs)


@lru_cache(maxsize=None)
def dgrid_halo_plans(lay: TileLayout):
    n, h, nl = lay.n, lay.h, lay.nl
    (gu, lu, us), (gv, lv, vs) = _dgrid_face_tables(n, h)
    Nt = nl + 2 * h

    def window_u(b, c):
        return (
            slice(b * nl, b * nl + Nt + 1),
            slice(c * nl, c * nl + Nt),
        )

    def window_v(b, c):
        return (
            slice(b * nl, b * nl + Nt),
            slice(c * nl, c * nl + Nt + 1),
        )

    block = _dgrid_block(lay)
    pu = build_compressed_plan(
        *_tile_tables(lay, gu, lu, us, _dgrid_owner_vec, block, window_u, (Nt + 1, Nt))
    )
    pv = build_compressed_plan(
        *_tile_tables(lay, gv, lv, vs, _dgrid_owner_vec, block, window_v, (Nt, Nt + 1))
    )
    return pu, pv


# ---- C-grid ---------------------------------------------------------------


def _cgrid_face_tables(n, h, fill):
    from ..grid.halo import _cgrid_tables
    from .halo_spmd import _decode_pool

    (uf, us), (vf, vs) = _cgrid_tables(n, h, fill)
    size_u, size_v = n * (n + 1), (n + 1) * n
    gu, lu = _decode_pool(uf, size_u, size_v)
    gv, lv = _decode_pool(vf, size_u, size_v)
    return (gu, lu, us), (gv, lv, vs)


@lru_cache(maxsize=None)
def cgrid_halo_plans(lay: TileLayout, fill: str):
    n, h, nl = lay.n, lay.h, lay.nl
    (gu, lu, us), (gv, lv, vs) = _cgrid_face_tables(n, h, fill)
    from ..grid.halo import _cgrid_tables

    (uf, _), (vf, _) = _cgrid_tables(n, h, fill)
    Nt = nl + 2 * h
    # face-level out shapes
    uc_shape = uf.shape[1:]  # e.g. [N, N+1]
    vc_shape = vf.shape[1:]

    def window_uc(b, c):
        return (
            slice(b * nl, b * nl + Nt),
            slice(c * nl, c * nl + Nt + 1),
        )

    def window_vc(b, c):
        return (
            slice(b * nl, b * nl + Nt + 1),
            slice(c * nl, c * nl + Nt),
        )

    assert uc_shape[0] >= Nt and uc_shape[1] >= Nt + 1, uc_shape
    assert vc_shape[0] >= Nt + 1 and vc_shape[1] >= Nt, vc_shape
    block = _cgrid_block(lay)
    pu = build_compressed_plan(
        *_tile_tables(lay, gu, lu, us, _cgrid_owner_vec, block, window_uc, (Nt, Nt + 1))
    )
    pv = build_compressed_plan(
        *_tile_tables(lay, gv, lv, vs, _cgrid_owner_vec, block, window_vc, (Nt + 1, Nt))
    )
    return pu, pv


# --------------------------------------------------------------------------
# Runtime pool packing + public tiled exchanges
# --------------------------------------------------------------------------


def _pack_scalar(field):
    """[L, lead..., nl, nl] local -> [lead..., L*nl*nl] (slot-major)."""
    lead = field.shape[1:-2]
    return torch.cat(
        [field[l].reshape(lead + (-1,)) for l in range(field.shape[0])],
        dim=-1,
    )


def _pack_uv(u, v):
    """u [L, lead..., a, b], v [L, lead..., c, d] -> slot-major pool."""
    lead = u.shape[1:-2]
    parts = []
    for l in range(u.shape[0]):
        parts.append(u[l].reshape(lead + (-1,)))
        parts.append(v[l].reshape(lead + (-1,)))
    return torch.cat(parts, dim=-1)


def _unlead(out):
    """plan output [lead..., L, a, b] -> [L, lead..., a, b]."""
    return out.movedim(-3, 0)


def halo_exchange_tiled(field, lay: TileLayout, fill: str = "none",
                        comm: Optional[Comm] = None):
    """field [L, lead..., nl, nl] -> [L, lead..., nl+2h, nl+2h]; comm:
    the Comm of the layout's ranks (default: the active spmd_mode's)."""
    plan = scalar_halo_plan(lay, fill)
    return _unlead(apply_plan(plan, _pack_scalar(field), _comm(comm, lay)))


def halo_exchange_dgrid_tiled(u, v, lay: TileLayout,
                              comm: Optional[Comm] = None):
    outs = apply_plans(dgrid_halo_plans(lay), _pack_uv(u, v),
                       _comm(comm, lay))
    return tuple(_unlead(o) for o in outs)


def halo_exchange_cgrid_tiled(uc, vc, lay: TileLayout, fill: str = "y",
                              comm: Optional[Comm] = None):
    outs = apply_plans(cgrid_halo_plans(lay, fill), _pack_uv(uc, vc),
                       _comm(comm, lay))
    return tuple(_unlead(o) for o in outs)


# ---- boundary canonicalization / averaging --------------------------------


@lru_cache(maxsize=None)
def canon_cgrid_plans(lay: TileLayout):
    """Tiled C-grid boundary canonicalization: face tables sliced to the
    tiles' STORED windows (unpadded, incl. the redundant +1 edge)."""
    from ..grid.halo import _cgrid_boundary_canon_tables
    from .halo_spmd import _decode_pool

    n, h, nl = lay.n, lay.h, lay.nl
    (uc_idx, uc_coef, uc_rep, vc_idx, vc_coef, vc_rep) = (
        _cgrid_boundary_canon_tables(n)
    )
    size_u, size_v = n * (n + 1), (n + 1) * n

    def face_tables(idx, coef, rep, own_shape, own_offset):
        own_loc = (
            own_offset
            + np.arange(int(np.prod(own_shape[1:]))).reshape(
                own_shape[1:]
            )[None]
            * np.ones((6,) + own_shape[1:], np.int64)
        ).astype(np.int64)
        g, loc = _decode_pool(idx, size_u, size_v)
        faces = np.arange(6).reshape(6, 1, 1)
        g = np.where(rep, g, faces * np.ones_like(g))
        loc = np.where(rep, loc, own_loc)
        sg = np.where(rep, coef, 1.0)
        return g, loc, sg

    gu, lu, su = face_tables(uc_idx, uc_coef, uc_rep, (6, n, n + 1), 0)
    gv, lv, sv = face_tables(
        vc_idx, vc_coef, vc_rep, (6, n + 1, n), size_u
    )

    def window_uc(b, c):
        return (slice(b * nl, (b + 1) * nl),
                slice(c * nl, c * nl + nl + 1))

    def window_vc(b, c):
        return (slice(b * nl, b * nl + nl + 1),
                slice(c * nl, (c + 1) * nl))

    block = _cgrid_block(lay)
    pu = build_compressed_plan(
        *_tile_tables(lay, gu, lu, su, _cgrid_owner_vec, block, window_uc, (nl, nl + 1))
    )
    pv = build_compressed_plan(
        *_tile_tables(lay, gv, lv, sv, _cgrid_owner_vec, block, window_vc, (nl + 1, nl))
    )
    return pu, pv


def canonicalize_cgrid_boundary_tiled(uc, vc, lay: TileLayout,
                                      comm: Optional[Comm] = None):
    outs = apply_plans(canon_cgrid_plans(lay), _pack_uv(uc, vc),
                       _comm(comm, lay))
    return tuple(_unlead(o) for o in outs)


@lru_cache(maxsize=None)
def avg_dgrid_plans(lay: TileLayout):
    """Tiled D-grid shared-boundary averaging: 0.5*own + 0.5*partner at
    face boundaries, pass-through (with ghost refresh) elsewhere --
    encoded as TWO plans summed at runtime, exactly like the face path
    (halo_spmd._avg_plans)."""
    from ..grid.halo import _dgrid_boundary_pair_tables
    from .halo_spmd import _decode_pool

    n, h, nl = lay.n, lay.h, lay.nl
    (u_idx, u_sign, u_mask, v_idx, v_sign, v_mask) = (
        _dgrid_boundary_pair_tables(n)
    )
    size_u, size_v = (n + 1) * n, n * (n + 1)
    faces = np.arange(6)

    def face_tables(idx, sgn, mask, own_shape, own_offset):
        own_loc = (
            own_offset
            + np.arange(int(np.prod(own_shape[1:]))).reshape(
                own_shape[1:]
            )[None]
            * np.ones((6,) + own_shape[1:], np.int64)
        ).astype(np.int64)
        g, loc = _decode_pool(idx, size_u, size_v)
        g_own = faces.reshape(6, 1, 1) * np.ones_like(g)
        partner = (
            np.where(mask, g, g_own),
            np.where(mask, loc, own_loc),
            np.where(mask, 0.5 * sgn, 0.0),
        )
        own = (
            g_own,
            own_loc,
            np.where(mask, 0.5, 1.0),
        )
        return own, partner

    (u_own, u_part) = face_tables(u_idx, u_sign, u_mask,
                                  (6, n + 1, n), 0)
    (v_own, v_part) = face_tables(v_idx, v_sign, v_mask,
                                  (6, n, n + 1), size_u)

    def window_u(b, c):
        return (slice(b * nl, b * nl + nl + 1),
                slice(c * nl, (c + 1) * nl))

    def window_v(b, c):
        return (slice(b * nl, (b + 1) * nl),
                slice(c * nl, c * nl + nl + 1))

    block = _dgrid_block(lay)

    def mk(tabs, window, shape):
        g, loc, sg = tabs
        return build_compressed_plan(
            *_tile_tables(lay, g, loc, sg, _dgrid_owner_vec,
                          block, window, shape)
        )

    return (
        (mk(u_own, window_u, (nl + 1, nl)),
         mk(u_part, window_u, (nl + 1, nl))),
        (mk(v_own, window_v, (nl, nl + 1)),
         mk(v_part, window_v, (nl, nl + 1))),
    )


def average_dgrid_boundary_tiled(u, v, lay: TileLayout,
                                 comm: Optional[Comm] = None):
    (u_own, u_part), (v_own, v_part) = avg_dgrid_plans(lay)
    uo, up, vo, vp = apply_plans(
        (u_own, u_part, v_own, v_part), _pack_uv(u, v), _comm(comm, lay)
    )
    return _unlead(uo + up), _unlead(vo + vp)


# --------------------------------------------------------------------------
# Per-tile corner-lattice multiplicity (corner_div_damp weights)
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def tile_inv_corner_mult(lay: TileLayout) -> np.ndarray:
    """[Y, X, nl+1, nl+1] 1/multiplicity, where multiplicity counts how
    many LOCAL corner lattices (across all faces and tiles) compute the
    physical point: face interior 1 (x2/x4 on within-face tile
    boundaries), face edges 2 (x2 at tile boundaries along the edge),
    cube vertices 3.  For Y=X=1 this reduces exactly to the face-level
    sw._corner_multiplicity table."""
    n, nl = lay.n, lay.nl
    out = np.zeros((lay.Y, lay.X, nl + 1, nl + 1))
    for b in range(lay.Y):
        for c in range(lay.X):
            J = b * nl + np.arange(nl + 1)[:, None]
            I = c * nl + np.arange(nl + 1)[None, :]
            edge_j = (J == 0) | (J == n)
            edge_i = (I == 0) | (I == n)
            ty = ((J % nl == 0) & (J > 0) & (J < n)).astype(int) + 1
            tx = ((I % nl == 0) & (I > 0) & (I < n)).astype(int) + 1
            interior = ty * tx
            edge = np.where(edge_j, 2 * tx, 2 * ty)
            mult = np.where(
                edge_j & edge_i, 3.0,
                np.where(edge_j | edge_i, edge, interior),
            )
            out[b, c] = 1.0 / mult
    return out


# --------------------------------------------------------------------------
# Within-face one-ring extension (remap staggered-pressure support)
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def extend1_plan(lay: TileLayout) -> CompressedPlan:
    """Pad each tile by ONE ghost cell per side with WITHIN-FACE
    neighbors, edge-replicated at the face boundary -- the tiled
    counterpart of the edge-replicating pad on the full face
    (grid.halo.extend_cells_one).  Used where face-level code takes a
    one-sided boundary form that must stay one-sided at face edges but
    become two-sided at interior tile boundaries (e.g. remap_step's
    staggered interface pressures)."""
    n, nl = lay.n, lay.nl
    idx = np.clip(np.arange(-1, n + 1), 0, n - 1)
    J = idx[:, None] * np.ones((1, n + 2), np.int64)
    I = np.ones((n + 2, 1), np.int64) * idx[None, :]
    face_loc = (J * n + I)[None] * np.ones((6, 1, 1), np.int64)
    face_src = np.arange(6)[:, None, None] * np.ones_like(face_loc)
    sign = np.ones_like(face_loc, np.float64)

    def window(b, c):
        return (
            slice(b * nl, b * nl + nl + 2),
            slice(c * nl, c * nl + nl + 2),
        )

    return build_compressed_plan(
        *_tile_tables(lay, face_src, face_loc, sign,
                      _scalar_owner_vec, _scalar_block(lay), window,
                      (nl + 2, nl + 2))
    )


def extend_cells_one_tiled(field, lay: TileLayout,
                           comm: Optional[Comm] = None):
    """field [L, lead..., nl, nl] -> [L, lead..., nl+2, nl+2]."""
    plan = extend1_plan(lay)
    return _unlead(apply_plan(plan, _pack_scalar(field), _comm(comm, lay)))
