"""Explicit halo exchange over the face axis of a mesh: the ranks of a
process group (``Comm``) or the shards of one process (``LocalComm``).

Counterpart of the JAX package's ``parallel/halo_spmd.py``.  Each rank
holds one face ([1, ..., n, n]); every exchange of ``grid/halo.py``
(scalar, D-grid, C-grid, boundary canonicalisation and averaging) runs as
a shard-local gather, one round of point-to-point messages carrying only
the slots a neighbour needs, and one gather that assembles the output.
The exchange plans are the JAX package's host numpy, copied: for every
output slot, (source face, face-local pool index, sign), built from the
same topology tables as the single-process exchange, so the two are the
same numbers (the forward exchanges are copies times +-1).

Where JAX sends each plan round as a ``ppermute``, here all the rounds
of an exchange go at once: one message per (sender, receiver) pair,
posted with ``isend``/``irecv`` and waited on together.  With the gloo
backend (several ranks on one card, or CPU ranks) a message is staged
through the host: the payload is copied to the CPU, sent, and copied
back to the receiver's device; with NCCL (one card per rank) it stays on
the device.  ``Comm`` counts the calls and times them apart from the
compute the rank has queued before each.  Between the shards of one
process (``LocalComm``, a local mesh's) a message is the sender's device
tensor itself, handed to the receiver in memory and ordered on the card
by an event: no copy, no host synchronisation, and so an exchange a CUDA
graph can hold.

Each exchange is a ``torch.autograd.Function``: its backward runs the
inverse messages (each receiver ships the cotangents of the slots it
received back to their sender) and then the transpose of the local
gather, as gathers: the cotangent of a pool entry is the sum of its
readers' cotangents times their signs, taken in a fixed order -- by
output, receiving rank, slot -- which is the order of the
single-process gather transpose (``grid/halo_transpose.py``) on a face
mesh, so the sums round alike.  This is the port's form of "jax.vjp
transposes ppermute exactly": the dampers that build M^T(W M) with
``torch.func.vjp`` (``dycore/sw.py``) run unchanged on a shard.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..grid import topology as topo


# --------------------------------------------------------------------------
# the communicator of one mesh axis
# --------------------------------------------------------------------------


class Comm:
    """The ranks of one exchange axis: device index d of a plan is global
    rank ``ranks[d]``; this process is device ``index``.

    ``exchange`` posts every receive and send of one exchange and waits
    for them; a hung peer fails it after the process group's timeout.
    ``calls`` and ``bytes`` count the exchanges.  Under host staging an
    exchange first waits for the work this rank has queued on its card
    (``wait_seconds``), so that its clock, ``seconds``, holds only the
    exchange: the device-host copies (``copy_seconds``) and the messages,
    which include waiting for the slowest peer to send."""

    def __init__(self, ranks: Sequence[int]):
        self.ranks = tuple(int(r) for r in ranks)
        self.index = self.ranks.index(dist.get_rank())
        self.staging = dist.get_backend() != "nccl"
        self.reset_counts()

    @property
    def size(self) -> int:
        return len(self.ranks)

    def reset_counts(self):
        self.calls, self.bytes = 0, 0
        self.seconds = self.wait_seconds = self.copy_seconds = 0.0

    def exchange(self, sends: Dict[int, torch.Tensor],
                 recvs: Dict[int, int], like: torch.Tensor):
        """Send ``sends[d]`` ([lead..., k]) to device d and receive
        ``recvs[d]`` entries from device d; returns {d: [lead..., k]} on
        like's device."""
        staged = self.staging and like.is_cuda
        if staged:
            # the copy to the host would wait for it anyway
            w0 = time.perf_counter()
            torch.cuda.current_stream(like.device).synchronize()
            self.wait_seconds += time.perf_counter() - w0
        t0 = time.perf_counter()
        lead = tuple(like.shape[:-1])
        m = int(np.prod(lead, dtype=np.int64))
        where = "cpu" if self.staging else like.device
        # one buffer each way, a slice of it a peer: under host staging
        # one device-to-host and one host-to-device copy an exchange
        send_peers, recv_peers = sorted(sends), sorted(recvs)
        out_buf = (
            torch.cat([sends[d].detach().reshape(-1) for d in send_peers])
            .to(where) if send_peers else None
        )
        t1 = time.perf_counter()
        in_buf = torch.empty(m * sum(recvs.values()), dtype=like.dtype,
                             device=where)
        reqs, start = [], 0
        for d in recv_peers:
            k = m * recvs[d]
            reqs.append(dist.irecv(in_buf[start:start + k],
                                   src=self.ranks[d]))
            start += k
        start = 0
        for d in send_peers:
            k = sends[d].numel()
            reqs.append(dist.isend(out_buf[start:start + k],
                                   dst=self.ranks[d]))
            start += k
        for r in reqs:
            r.wait()
        if out_buf is not None:
            self.bytes += out_buf.numel() * out_buf.element_size()
        t2 = time.perf_counter()
        in_buf = in_buf.to(like.device)
        if staged:  # a copy from pageable memory: synchronous
            self.copy_seconds += (t1 - t0) + (time.perf_counter() - t2)
        out, start = {}, 0
        for d in recv_peers:
            k = m * recvs[d]
            out[d] = in_buf[start:start + k].reshape(lead + (recvs[d],))
            start += k
        self.calls += 1
        self.seconds += time.perf_counter() - t0
        return out


class LocalHub:
    """What the shards of one process share for their exchanges: the
    turn, the payloads in flight and, on the card, each shard's events.

    The shards' threads run one at a time, in turns (shard order): each
    runs until its next exchange, posts its payloads there and hands the
    turn on (``pass_turn``).  When a shard's turn comes back, every shard
    has posted that exchange's payloads: a barrier, taken in turns, so
    that no two shards' Python runs at once (threads that take the
    interpreter lock by turns at every torch op spend their time handing
    it over).  On the card a shard's thread only enqueues work on its own
    stream, so the device runs the shards' kernels concurrently all the
    same.  A payload posted at a shard's k-th exchange waits in slot
    k % 2 until its receiver takes it: a sender posts its (k+2)-th only
    after every shard has had its turn past the (k+1)-th, and taken its
    k-th payloads before.  A wait for the turn lasts at most
    ``timeout_s``; ``abort`` (or a wait that times out) breaks the hub,
    so that every shard waiting, or coming to wait, raises
    ``threading.BrokenBarrierError``."""

    def __init__(self, size: int, timeout_s: float):
        self.size, self.timeout_s = size, timeout_s
        self.lock = threading.Lock()
        # a condition a shard, so that handing the turn on wakes only the
        # shard whose turn it is
        self.conds = [threading.Condition(self.lock) for _ in range(size)]
        self.events = {}  # (shard, slot) -> torch.cuda.Event, kept
        self.reset()

    def reset(self):
        """Ready for a new run of the shards (after a broken one too)."""
        with self.lock:
            self.turn, self.broken = 0, False
            self.done = [False] * self.size
            self.slots = ({}, {})  # (sender, receiver) -> payload
            self.gen = [0] * self.size  # each shard's exchanges this run

    def _break(self):
        """Under the lock: every waiting shard wakes and raises."""
        self.broken = True
        for cond in self.conds:
            cond.notify()

    def _wait(self, d: int):
        """Under the lock: until it is shard d's turn."""
        if not self.conds[d].wait_for(
                lambda: self.broken or self.turn == d, self.timeout_s):
            self._break()
        if self.broken:
            raise threading.BrokenBarrierError(
                f"shard {d}: the hub is broken (a shard failed, or waited "
                f"more than {self.timeout_s} s for its turn)")

    def _hand_on(self, d: int):
        """Under the lock: the turn to the next shard after d that has
        not finished."""
        for k in range(1, self.size + 1):
            if not self.done[(d + k) % self.size]:
                self.turn = (d + k) % self.size
                self.conds[self.turn].notify()
                break

    def start(self, d: int):
        """Shard d's thread begins: wait for its first turn."""
        with self.lock:
            self._wait(d)

    def pass_turn(self, d: int):
        """Shard d at an exchange: the turn to the next shard, and back."""
        with self.lock:
            self._hand_on(d)
            self._wait(d)

    def finish(self, d: int):
        """Shard d's thread ends: it takes no more turns."""
        with self.lock:
            self.done[d] = True
            if self.turn == d:
                self._hand_on(d)

    def abort(self):
        with self.lock:
            self._break()


class LocalComm:
    """One shard's end of a local mesh's exchange axis: the interface of
    ``Comm`` (``size``, ``index``, ``exchange``, the counters), its peers
    the other shards of this process (``LocalHub``).

    ``exchange`` posts this shard's payloads, hands the turn on until
    every shard has posted (``LocalHub``) and takes its own: device
    tensors handed over as they are, with no copy and no
    synchronisation.  Each shard runs on a thread of its own
    (``parallel.mesh.LocalMesh.map``) and, on the card, on a stream of
    its own: a sender's stream records an event after its
    payloads, the receiver's stream waits for it, and each payload is
    marked as used on the receiver's stream (``record_stream``), so the
    caching allocator does not hand its memory to the sender's next
    tensor while the receiver may still read it.  In a CUDA-graph
    capture the events are the graph's edges between the shards'
    branches.  ``seconds`` is the time in the exchanges, the other
    shards' turns included; nothing is staged, so ``wait_seconds`` and
    ``copy_seconds`` stay 0."""

    def __init__(self, hub: LocalHub, index: int):
        self.hub, self.index = hub, index
        self.reset_counts()

    @property
    def size(self) -> int:
        return self.hub.size

    def reset_counts(self):
        self.calls, self.bytes = 0, 0
        self.seconds = self.wait_seconds = self.copy_seconds = 0.0

    def exchange(self, sends: Dict[int, torch.Tensor],
                 recvs: Dict[int, int], like: torch.Tensor):
        """``Comm.exchange``: send ``sends[d]`` ([lead..., k]) to shard d
        and take ``recvs[d]`` entries from shard d; returns {d: [lead...,
        k]}, the senders' own tensors."""
        t0 = time.perf_counter()
        hub, me = self.hub, self.index
        slot = hub.gen[me] % 2
        hub.gen[me] += 1
        posted = hub.slots[slot]
        for d, x in sends.items():
            posted[(me, d)] = x.detach()
            self.bytes += x.numel() * x.element_size()
        stream = None
        if like.is_cuda:
            stream = torch.cuda.current_stream(like.device)
            event = hub.events.get((me, slot))
            if event is None:
                event = hub.events[(me, slot)] = torch.cuda.Event()
            event.record(stream)
        hub.pass_turn(me)
        out = {}
        for g in sorted(recvs):
            x = posted.pop((g, me))
            if x.shape[-1] != recvs[g]:
                raise ValueError(
                    f"shard {me}: {x.shape[-1]} entries from shard {g}, "
                    f"{recvs[g]} expected")
            if stream is not None:
                stream.wait_event(hub.events[(g, slot)])
                x.record_stream(stream)
            out[g] = x
        self.calls += 1
        self.seconds += time.perf_counter() - t0
        return out


# the communicators an exchange runs over: a process group's, a local
# mesh's
COMMS = (Comm, LocalComm)


# --------------------------------------------------------------------------
# global tables -> per-rank exchange
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Tables:
    """One exchange output over D devices: slot s of device d takes
    sign[d, s] * pool_{src[d, s]}[loc[d, s]]; sign 0 means no source
    (the slot is 0)."""

    out_shape: Tuple[int, ...]
    src: np.ndarray  # [D, S]
    loc: np.ndarray  # [D, S]
    sign: np.ndarray  # [D, S]


def pool_plan_tables(plan) -> Tables:
    """The global tables of a ``_PoolPlan`` (face-mesh rounds)."""
    D, S = plan.local_tbl.shape
    src = np.full((D, S), -1, np.int64)
    loc = np.zeros((D, S), np.int64)
    sign = np.zeros((D, S))
    own = plan.local_sign != 0
    src[own] = np.nonzero(own)[0]
    loc[own] = plan.local_tbl[own]
    sign[own] = plan.local_sign[own]
    for rnd in plan.rounds:
        for g, f in rnd.perm:
            live = rnd.sign[g] != 0
            src[f, live] = g
            loc[f, live] = rnd.tbl[g, live]
            sign[f, live] = rnd.sign[g, live]
    return Tables(tuple(plan.out_shape), src, loc, sign)


class RankExchange:
    """The runtime tables of one rank for a group of outputs that read one
    pool (e.g. the u and v outputs of a D-grid exchange).

    Forward: buf = [0 | own entries | the message of each peer, peers in
    order]; output t = buf[final[t]].  Backward: the cotangents of the
    received slots go back to their senders; X = [0 | own entries'
    cotangents | the cotangents back from each peer]; the cotangent of a
    pool entry is its one reader's (sign 1) or the sum of its readers'
    times their signs, readers in (output, receiving rank, slot) order.
    """

    def __init__(self, tables: Sequence[Tables], d: int, pool_size: int):
        D = tables[0].src.shape[0]
        self.d, self.pool_size = d, pool_size
        self.out_shapes = [t.out_shape for t in tables]
        live = [(t.sign != 0) & (t.src >= 0) for t in tables]
        # own entries, then each feeding peer's message, in (t, s) order
        self.final = [np.zeros(t.src.shape[1], np.int64) for t in tables]
        self.live_idx = []
        pos = 1
        own_loc, own_sign, own_key = [], [], []
        for t, tb in enumerate(tables):
            idx = np.nonzero(live[t][d] & (tb.src[d] == d))[0]
            self.final[t][idx] = pos + np.arange(len(idx))
            pos += len(idx)
            own_loc.append(tb.loc[d, idx])
            own_sign.append(tb.sign[d, idx])
            own_key.append(np.stack(
                [np.full(len(idx), t), np.full(len(idx), d), idx], 1
            ))
        self.n_own = pos - 1
        self.recv = {}  # peer -> (start in buf, count)
        for g in range(D):
            if g == d:
                continue
            start = pos
            for t, tb in enumerate(tables):
                idx = np.nonzero(live[t][d] & (tb.src[d] == g))[0]
                self.final[t][idx] = pos + np.arange(len(idx))
                pos += len(idx)
            if pos > start:
                self.recv[g] = (start, pos - start)
        self.buf_size = pos
        for t in range(len(tables)):
            self.live_idx.append(np.nonzero(self.final[t])[0])
        # what this rank sends each peer, in the peer's (t, s) order
        self.send = {}
        send_key = {}
        for r in range(D):
            if r == d:
                continue
            locs, signs, keys = [], [], []
            for t, tb in enumerate(tables):
                idx = np.nonzero(live[t][r] & (tb.src[r] == d))[0]
                locs.append(tb.loc[r, idx])
                signs.append(tb.sign[r, idx])
                keys.append(np.stack(
                    [np.full(len(idx), t), np.full(len(idx), r), idx], 1
                ))
            if sum(len(x) for x in locs):
                self.send[r] = (np.concatenate(locs), np.concatenate(signs))
                send_key[r] = np.concatenate(keys)
        self.own_loc = np.concatenate(own_loc)
        self.own_sign = np.concatenate(own_sign)
        # the transpose: readers of every pool entry in key order
        ent = [self.own_loc] + [self.send[r][0] for r in sorted(self.send)]
        sgn = [self.own_sign] + [self.send[r][1] for r in sorted(self.send)]
        key = [np.concatenate(own_key).reshape(-1, 3)] + [
            send_key[r] for r in sorted(self.send)
        ]
        ent = np.concatenate(ent).astype(np.int64)
        sgn = np.concatenate(sgn)
        key = np.concatenate(key)
        xpos = 1 + np.arange(len(ent))  # X[0] is 0
        order = np.lexsort((key[:, 2], key[:, 1], key[:, 0], ent))
        ent, sgn, xpos = ent[order], sgn[order], xpos[order]
        count = np.bincount(ent, minlength=pool_size)
        first = np.concatenate([[0], np.cumsum(count)[:-1]])
        single = np.zeros(pool_size, bool)
        one = np.nonzero(count == 1)[0]
        single[one] = sgn[first[one]] == 1.0
        band_e = np.nonzero((count >= 1) & ~single)[0]
        K = int(count[band_e].max()) if len(band_e) else 1
        E = len(band_e)
        band_pos = np.zeros((K, E), np.int64)
        band_sign = np.zeros((K, E))
        for k in range(K):
            has = count[band_e] > k
            sel = first[band_e[has]] + k
            band_pos[k, has] = xpos[sel]
            band_sign[k, has] = sgn[sel]
        self.x_size = 1 + len(ent)
        direct = np.zeros(pool_size, np.int64)
        direct[single] = xpos[first[single]]
        direct[band_e] = self.x_size + np.arange(E)
        self.direct, self.band_pos, self.band_sign = direct, band_pos, band_sign
        self._dev = {}

    def tensors(self, device, dtype):
        key = (device, dtype)
        if key not in self._dev:
            def ix(a):
                return torch.as_tensor(np.asarray(a, np.int64), device=device)

            def fl(a):
                return torch.as_tensor(np.asarray(a), dtype=dtype,
                                       device=device)

            self._dev[key] = dict(
                own_loc=ix(self.own_loc), own_sign=fl(self.own_sign),
                send={r: (ix(a), fl(b)) for r, (a, b) in self.send.items()},
                final=[ix(f) for f in self.final],
                live=[ix(i) for i in self.live_idx],
                final_live=[ix(f[i]) for f, i in zip(self.final,
                                                     self.live_idx)],
                direct=ix(self.direct), band_pos=ix(self.band_pos),
                band_sign=fl(self.band_sign),
            )
        return self._dev[key]

    def forward(self, pool, comm: Comm):
        tt = self.tensors(pool.device, pool.dtype)
        lead = tuple(pool.shape[:-1])
        sends = {r: pool[..., i] * s for r, (i, s) in tt["send"].items()}
        got = comm.exchange(
            sends, {g: c for g, (_, c) in self.recv.items()}, pool
        )
        buf = torch.cat(
            [pool.new_zeros(lead + (1,)),
             pool[..., tt["own_loc"]] * tt["own_sign"]]
            + [got[g] for g in sorted(got)], dim=-1,
        )
        return tuple(
            buf[..., f].reshape(lead + tuple(shp))
            for f, shp in zip(tt["final"], self.out_shapes)
        )

    def transpose(self, cts, comm: Comm):
        ref = cts[0]
        tt = self.tensors(ref.device, ref.dtype)
        lead = tuple(ref.shape[: ref.ndim - len(self.out_shapes[0])])
        ct_buf = ref.new_zeros(lead + (self.buf_size,))
        for t, ct in enumerate(cts):
            flat = ct.reshape(lead + (-1,))
            ct_buf.index_copy_(-1, tt["final_live"][t],
                               flat.index_select(-1, tt["live"][t]))
        back = comm.exchange(
            {g: ct_buf[..., s:s + c] for g, (s, c) in self.recv.items()},
            {r: len(i) for r, (i, _) in self.send.items()}, ct_buf,
        )
        X = torch.cat(
            [ct_buf[..., : 1 + self.n_own]] + [back[r] for r in sorted(back)],
            dim=-1,
        )
        band = (X[..., tt["band_pos"]] * tt["band_sign"]).sum(-2)
        return torch.cat([X, band], dim=-1)[..., tt["direct"]]


class _Exchange(torch.autograd.Function):
    """pool [lead..., P] -> the exchange's outputs; backward = the
    inverse messages and the gather-form transpose."""

    @staticmethod
    def forward(pool, rx, comm):
        return rx.forward(pool, comm)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.rx, ctx.comm = inputs

    @staticmethod
    def backward(ctx, *cts):
        return ctx.rx.transpose(cts, ctx.comm), None, None


def run_exchange(rx: RankExchange, pool, comm: Comm):
    """The outputs of `rx` from this rank's pool (differentiable)."""
    return _Exchange.apply(pool, rx, comm)


@lru_cache(maxsize=None)
def _rank_exchange(kind: str, args: tuple, d: int) -> RankExchange:
    """The per-rank exchange of a face-mesh plan, cached."""
    plans, pool_size = _FACE_PLANS[kind](*args)
    return RankExchange([pool_plan_tables(p) for p in plans], d, pool_size)


def _comm_of(axis):
    if axis is None:
        from ..grid import halo as halo_mod

        axis = halo_mod.spmd_axis()
    if not isinstance(axis, COMMS) or axis.size != 6:
        raise ValueError(
            "the face-mesh exchanges need the Comm of a 6-rank face axis"
        )
    return axis


# --------------------------------------------------------------------------
# plans (host numpy, copied from the JAX package)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Round:
    """One ppermute round for a halo block: each sender appears once."""

    perm: Tuple[Tuple[int, int], ...]  # (src_face, dst_face)
    tbl_stack: np.ndarray  # [6, block_cells] local flat gather indices


def _blocks(n: int, h: int):
    N = n + 2 * h
    return {
        "S": (slice(0, h), slice(h, h + n)),
        "N": (slice(h + n, N), slice(h, h + n)),
        "W": (slice(h, h + n), slice(0, h)),
        "E": (slice(h, h + n), slice(h + n, N)),
        "SW": (slice(0, h), slice(0, h)),
        "SE": (slice(0, h), slice(h + n, N)),
        "NW": (slice(h + n, N), slice(0, h)),
        "NE": (slice(h + n, N), slice(h + n, N)),
    }


@lru_cache(maxsize=None)
def _exchange_plan(n: int, h: int, fill: str):
    """Rounds for every halo block, from the topology tables."""
    if fill == "none":
        src_face, src_j, src_i, _ = topo.halo_source_indices(n, h)
    else:
        src_face, src_j, src_i, _ = topo.halo_source_indices_filled(
            n, h, fill
        )
    plan: Dict[str, List[_Round]] = {}
    for name, (rows, cols) in _blocks(n, h).items():
        sf = src_face[:, rows, cols]  # [6, bh, bw] per receiver
        sj = src_j[:, rows, cols]
        si = src_i[:, rows, cols]
        bh, bw = sf.shape[1], sf.shape[2]
        # cells whose source is the receiver itself (clipped fill-none
        # corners referencing own edge cells) need no communication;
        # handled as a self-pair in a round.
        per_recv = []
        for f in range(6):
            faces = np.unique(sf[f])
            if len(faces) != 1:
                raise NotImplementedError(
                    f"halo block {name} of face {f} has mixed "
                    f"sources {faces}; split-by-source not needed "
                    "for the FV3 topology"
                )
            g = int(faces[0])
            tbl = (sj[f] * n + si[f]).astype(np.int32).ravel()
            per_recv.append((g, tbl))
        # group receivers into rounds with unique senders
        rounds: List[_Round] = []
        remaining = list(range(6))
        while remaining:
            used, perm, batch = set(), [], {}
            rest = []
            for f in remaining:
                g, tbl = per_recv[f]
                if g in used:
                    rest.append(f)
                    continue
                used.add(g)
                perm.append((g, f))
                batch[g] = tbl
            tbl_stack = np.zeros((6, bh * bw), np.int32)
            for g, tbl in batch.items():
                tbl_stack[g] = tbl
            rounds.append(_Round(tuple(perm), tbl_stack))
            remaining = rest
        plan[name] = rounds
    return plan, (n, h)


def halo_exchange_spmd(field, h: int, mesh, fill: str = "none"):
    """Pad this rank's face [1, ..., n, n] with h halo cells from the
    neighbours' edge strips (the block rounds of _exchange_plan), over
    the mesh's face axis (``mesh`` a CubedSphereMesh or a Comm).

    Semantically identical to grid.halo.halo_exchange (same topology
    tables)."""
    comm = mesh if isinstance(mesh, Comm) else mesh.face_comm
    comm = _comm_of(comm)
    n = field.shape[-1]
    local = field[0]
    lead = local.shape[:-2]
    rx = _rank_exchange("strips", (n, h, fill), comm.index)
    (out,) = run_exchange(rx, local.reshape(lead + (n * n,)), comm)
    return out[None]


def _strip_plan(n: int, h: int, fill: str):
    """_exchange_plan's block rounds as one _PoolPlan over the padded
    face (interior: own cells)."""
    plan, _ = _exchange_plan(n, h, fill)
    N = n + 2 * h
    src = np.zeros((6, N, N), np.int64)
    loc = np.zeros((6, N, N), np.int64)
    sign = np.zeros((6, N, N))
    own = np.arange(n * n).reshape(n, n)
    src[:, h:h + n, h:h + n] = np.arange(6)[:, None, None]
    loc[:, h:h + n, h:h + n] = own
    sign[:, h:h + n, h:h + n] = 1.0
    for name, (rows, cols) in _blocks(n, h).items():
        for rnd in plan[name]:
            for g, f in rnd.perm:
                bh = rows.stop - rows.start
                src[f, rows, cols] = g
                loc[f, rows, cols] = rnd.tbl_stack[g].reshape(bh, -1)
                sign[f, rows, cols] = 1.0
    return (_build_pool_plan(src, loc, sign),), n * n


@dataclasses.dataclass(frozen=True)
class _PoolRound:
    perm: Tuple[Tuple[int, int], ...]
    tbl: np.ndarray  # [6, out_size] SENDER-side local gather indices
    sign: np.ndarray  # [6, out_size] SENDER-side signs (0 = not sent)


@dataclasses.dataclass(frozen=True)
class _PoolPlan:
    out_shape: Tuple[int, ...]
    local_tbl: np.ndarray  # [6, out_size]
    local_sign: np.ndarray
    rounds: Tuple[_PoolRound, ...]


def _decode_pool(flat, size_u, size_v):
    """Global pool index ([6*size_u] u-block then [6*size_v] v-block)
    -> (source face, face-local pool index in [0, size_u+size_v))."""
    flat = np.asarray(flat, np.int64)
    in_u = flat < 6 * size_u
    g = np.where(in_u, flat // size_u, (flat - 6 * size_u) // size_v)
    loc = np.where(
        in_u, flat % size_u, size_u + (flat - 6 * size_u) % size_v
    )
    return g.astype(np.int32), loc.astype(np.int32)


def _build_pool_plan(src_face, src_loc, sign):
    """Build gather+ppermute rounds from per-receiver full tables.

    src_face/src_loc/sign: [6, *out_shape]; each receiver face f's
    output slot takes sign * pool_{src_face}[src_loc].  Entries with
    sign == 0 contribute nothing.
    """
    out_shape = src_face.shape[1:]
    size = int(np.prod(out_shape))
    sf = src_face.reshape(6, size)
    sl = src_loc.reshape(6, size)
    sg = np.asarray(sign, np.float64).reshape(6, size)
    own = sf == np.arange(6)[:, None]
    local_tbl = np.where(own, sl, 0).astype(np.int32)
    local_sign = np.where(own, sg, 0.0)
    pairs = {}
    for f in range(6):
        for gv in np.unique(sf[f]):
            g = int(gv)
            if g == f:
                continue
            mask = (sf[f] == g) & (sg[f] != 0)
            if not mask.any():
                continue
            pairs[(g, f)] = (
                np.where(mask, sl[f], 0).astype(np.int32),
                np.where(mask, sg[f], 0.0),
            )
    rounds = []
    rem = dict(pairs)
    while rem:
        used_s, used_r, batch = set(), set(), {}
        for (gf, ff) in list(rem):
            if gf in used_s or ff in used_r:
                continue
            used_s.add(gf)
            used_r.add(ff)
            batch[(gf, ff)] = rem.pop((gf, ff))
        tbl = np.zeros((6, size), np.int32)
        sg_s = np.zeros((6, size))
        for (gf, ff), (t, s) in batch.items():
            tbl[gf] = t
            sg_s[gf] = s
        rounds.append(_PoolRound(tuple(batch), tbl, sg_s))
    return _PoolPlan(tuple(out_shape), local_tbl, local_sign,
                     tuple(rounds))


def _uv_pool(u, v):
    """Local (face-axis-1) staggered pair -> [lead..., size_u+size_v]
    pool."""
    ul = u[0]
    vl = v[0]
    lead = ul.shape[:-2]
    return torch.cat(
        [ul.reshape(lead + (-1,)), vl.reshape(lead + (-1,))], dim=-1
    )


def _pair_local(kind, args, a, b, axis):
    comm = _comm_of(axis)
    rx = _rank_exchange(kind, args, comm.index)
    outs = run_exchange(rx, _uv_pool(a, b), comm)
    return tuple(o[None] for o in outs)


@lru_cache(maxsize=None)
def _dgrid_plans(n: int, h: int):
    from ..grid.halo import _dgrid_tables

    (uf, us), (vf, vs) = _dgrid_tables(n, h)
    size_u, size_v = (n + 1) * n, n * (n + 1)
    gu, lu = _decode_pool(uf, size_u, size_v)
    gv, lv = _decode_pool(vf, size_u, size_v)
    return (
        _build_pool_plan(gu, lu, us),
        _build_pool_plan(gv, lv, vs),
    )


def halo_exchange_dgrid_local(u, v, h: int, axis=None):
    """shard-local D-grid exchange (u [1,...,n+1,n], v [1,...,n,n+1]);
    axis: the face axis's Comm (default: the active spmd_mode's)."""
    return _pair_local("dgrid", (u.shape[-1], h), u, v, axis)


@lru_cache(maxsize=None)
def _cgrid_plans(n: int, h: int, fill: str):
    from ..grid.halo import _cgrid_tables

    (uf, us), (vf, vs) = _cgrid_tables(n, h, fill)
    size_u, size_v = n * (n + 1), (n + 1) * n
    gu, lu = _decode_pool(uf, size_u, size_v)
    gv, lv = _decode_pool(vf, size_u, size_v)
    return (
        _build_pool_plan(gu, lu, us),
        _build_pool_plan(gv, lv, vs),
    )


def halo_exchange_cgrid_local(uc, vc, h: int, fill: str = "y",
                              axis=None):
    return _pair_local("cgrid", (uc.shape[-2], h, fill), uc, vc, axis)


@lru_cache(maxsize=None)
def _canon_plans(n: int):
    from ..grid.halo import _cgrid_boundary_canon_tables

    (uc_idx, uc_coef, uc_rep, vc_idx, vc_coef, vc_rep) = (
        _cgrid_boundary_canon_tables(n)
    )
    size_u, size_v = n * (n + 1), (n + 1) * n
    faces = np.arange(6)

    def mk(idx, coef, rep, own_shape, own_offset):
        # slots not replaced read their OWN local value
        own_loc = (
            own_offset
            + np.arange(int(np.prod(own_shape[1:])))
            .reshape(own_shape[1:])[None]
            * np.ones((6,) + own_shape[1:], np.int64)
        ).astype(np.int64)
        g, loc = _decode_pool(idx, size_u, size_v)
        g = np.where(rep, g, faces.reshape(6, 1, 1))
        loc = np.where(rep, loc, own_loc)
        sg = np.where(rep, coef, 1.0)
        return _build_pool_plan(g, loc.astype(np.int32), sg)

    pu = mk(uc_idx, uc_coef, uc_rep, (6, n, n + 1), 0)
    pv = mk(vc_idx, vc_coef, vc_rep, (6, n + 1, n), size_u)
    return pu, pv


def canonicalize_cgrid_boundary_local(uc, vc, axis=None):
    return _pair_local("canon", (uc.shape[-2],), uc, vc, axis)


@lru_cache(maxsize=None)
def _avg_plans(n: int):
    from ..grid.halo import _dgrid_boundary_pair_tables

    (u_idx, u_sign, u_mask, v_idx, v_sign, v_mask) = (
        _dgrid_boundary_pair_tables(n)
    )
    size_u, size_v = (n + 1) * n, n * (n + 1)
    faces = np.arange(6)

    def mk(idx, sgn, mask, own_shape, own_offset):
        own_loc = (
            own_offset
            + np.arange(int(np.prod(own_shape[1:])))
            .reshape(own_shape[1:])[None]
            * np.ones((6,) + own_shape[1:], np.int64)
        ).astype(np.int64)
        g, loc = _decode_pool(idx, size_u, size_v)
        # averaged slots: 0.5*own + 0.5*sign*partner; others: own
        g_own = faces.reshape(6, 1, 1) * np.ones_like(g)
        # build as TWO stacked contributions by summing plans is
        # awkward; instead encode: own part via local identity plan,
        # partner part via a masked remote plan, combined at runtime.
        partner = _build_pool_plan(
            np.where(mask, g, g_own),
            np.where(mask, loc, own_loc).astype(np.int32),
            np.where(mask, 0.5 * sgn, 0.0),
        )
        own = _build_pool_plan(
            g_own.astype(np.int32),
            own_loc.astype(np.int32),
            np.where(mask, 0.5, 1.0),
        )
        return own, partner

    return (
        mk(u_idx, u_sign, u_mask, (6, n + 1, n), 0),
        mk(v_idx, v_sign, v_mask, (6, n, n + 1), size_u),
    )


def average_dgrid_boundary_local(u, v, axis=None):
    uo, up, vo, vp = _pair_local("avg", (u.shape[-1],), u, v, axis)
    return uo + up, vo + vp


def halo_exchange_local(field, h: int, fill: str = "none", axis=None):
    """shard-local scalar halo exchange (field [1, ..., n, n]):
    identical semantics to grid.halo.halo_exchange."""
    comm = _comm_of(axis)
    n = field.shape[-1]
    local = field[0]
    lead = local.shape[:-2]
    rx = _rank_exchange("scalar", (n, h, fill), comm.index)
    (out,) = run_exchange(rx, local.reshape(lead + (-1,)), comm)
    return out[None]


@lru_cache(maxsize=None)
def _scalar_full_plan(n: int, h: int, fill: str):
    from ..grid import topology as topo

    if fill == "none":
        src_face, src_j, src_i, _ = topo.halo_source_indices(n, h)
    else:
        src_face, src_j, src_i, _ = topo.halo_source_indices_filled(
            n, h, fill
        )
    loc = (src_j.astype(np.int64) * n + src_i).astype(np.int32)
    sign = np.ones_like(loc, np.float64)
    return _build_pool_plan(
        src_face.astype(np.int32), loc, sign
    )


def _pool_sizes(kind, n):
    return {
        "dgrid": 2 * (n + 1) * n, "cgrid": 2 * n * (n + 1),
        "canon": 2 * n * (n + 1), "avg": 2 * (n + 1) * n,
    }[kind]


_FACE_PLANS = {
    "strips": _strip_plan,
    "scalar": lambda n, h, fill: ((_scalar_full_plan(n, h, fill),), n * n),
    "dgrid": lambda n, h: (_dgrid_plans(n, h), _pool_sizes("dgrid", n)),
    "cgrid": lambda n, h, fill: (
        _cgrid_plans(n, h, fill), _pool_sizes("cgrid", n)
    ),
    "canon": lambda n: (_canon_plans(n), _pool_sizes("canon", n)),
    "avg": lambda n: (
        tuple(p for pair in _avg_plans(n) for p in pair),
        _pool_sizes("avg", n),
    ),
}
