"""K5's plain version (fv3net_tpu_torch ops.remap.remap_levels_plain, the
conservative remap on the native [F, nz, Y, X] layout) against the JAX
package's Pallas kernel ppm_remap_pallas, run in interpret mode on the
CPU as tests/test_pallas_kernels.py:214-245 runs it, with that test's
inputs and tolerance (2e-5), plus the dispatch of remap_levels on CPU
tensors.

Both run in float64 on the f32-rounded inputs: in float32 the comparison
would measure rounding order, not the algorithm -- with these inputs the
Pallas kernel's cumulative integration is 1.7e-2 from its own float64
answer in thin target layers (the port integrates per layer overlap,
4e-6 from it).  Limiter branches that sit on an exact tie (see
tests/test_torch_remap.py) may go either way in two correct
implementations: a column may differ only where the oracle flags a tie
in its profile.  A scalar mirror of the K5 kernel's merge walk and
streamed profile is held against the plain version in float64."""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fv3net_tpu_torch
from fv3net_tpu.ops.pallas_remap import ppm_remap_pallas
from fv3net_tpu_torch.ops import remap as tremap
from fv3net_tpu_torch.ops.cuda_remap import ppm_remap_cuda
from reference_mappm import cs_profile_ref
from test_pallas_kernels import _remap_args

torch.set_num_threads(1)


def _inputs(stag=(0, 0), seed=0):
    """The JAX kernel test's q, pe1, pe2 [6, 13, Y, X], as float64."""
    return [np.asarray(a, np.float64)
            for a in _remap_args(stag=stag, seed=seed)]


def _tie_columns(q, pe1, iv, kord):
    """[F, Y, X]: the oracle's profile of the column has a branch tie."""
    F, _, Y, X = q.shape
    dp = np.diff(pe1, axis=1)
    tie = np.zeros((F, Y, X), bool)
    for f in range(F):
        for y in range(Y):
            for x in range(X):
                tie[f, y, x] = cs_profile_ref(
                    q[f, :, y, x], dp[f, :, y, x], iv, kord,
                    return_ties=True,
                )[3].any()
    return tie


@pytest.mark.parametrize("stag", [(0, 0), (1, 0), (0, 1)])
@pytest.mark.parametrize("kord", [9, 10, 17])
@pytest.mark.parametrize("iv", [1, 0, -1])
def test_remap_levels_plain_matches_pallas(iv, kord, stag):
    q, pe1, pe2 = _inputs(stag)
    want = np.asarray(ppm_remap_pallas(
        jnp.asarray(q), jnp.asarray(pe1), jnp.asarray(pe2), iv=iv,
        kord=kord, interpret=True,
    ))
    got = tremap.remap_levels_plain(
        *(torch.as_tensor(a) for a in (q, pe1, pe2)), iv, kord
    ).numpy()
    bad = (np.abs(got - want) > 2e-5 + 2e-5 * np.abs(want)).any(axis=1)
    if bad.any():
        tie = _tie_columns(q, pe1, iv, kord)
        assert not (bad & ~tie).any(), (
            f"{int((bad & ~tie).sum())} tie-free columns differ"
        )
        assert bad.mean() < 0.1, f"{bad.mean():.2f} of the columns differ"


@pytest.mark.parametrize("kord", [9, 10, 17])
def test_remap_levels_plain_conservative(kord):
    """Column mass (test_pallas_kernels.py:233-245), here in float32."""
    q, pe1, pe2 = (torch.as_tensor(a).float() for a in _inputs(seed=4))
    out = tremap.remap_levels_plain(q, pe1, pe2, 1, kord)
    m1 = (q * (pe1[:, 1:] - pe1[:, :-1])).double().sum(1)
    m2 = (out * (pe2[:, 1:] - pe2[:, :-1])).double().sum(1)
    np.testing.assert_allclose(m2.numpy(), m1.numpy(), rtol=2e-4)


def test_remap_levels_tracer_stack_equals_per_field():
    """A stack of fields on one pressure grid ([ntr * 6, ...] against
    [6, ...] pressures) remaps as each field alone."""
    q, pe1, pe2 = (torch.as_tensor(a) for a in _inputs(seed=2))
    stack = torch.cat([q, 0.5 * q.flip(1), q * q])
    got = tremap.remap_levels_plain(stack, pe1, pe2, 0, 9)
    for i in range(3):
        want = tremap.remap_levels_plain(stack[6 * i : 6 * i + 6], pe1, pe2,
                                         0, 9)
        assert torch.equal(got[6 * i : 6 * i + 6], want)


@pytest.mark.parametrize("iv,kord", [(1, 9), (0, 10), (-1, 17), (1, 7),
                                     (-2, 9)])
def test_remap_levels_cpu_is_plain_and_counts_nothing(iv, kord):
    q, pe1, pe2 = (torch.as_tensor(a) for a in _inputs(seed=3))
    ppm_remap_cuda.launches = 0
    got = tremap.remap_levels(q, pe1, pe2, iv, kord)
    want = tremap.remap_levels_plain(q, pe1, pe2, iv, kord)
    assert torch.equal(got, want)
    assert ppm_remap_cuda.launches == 0


def test_ppm_remap_cuda_refuses():
    q, pe1, pe2 = (torch.as_tensor(a).float() for a in _inputs(seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        ppm_remap_cuda(q, pe1, pe2, 1, 9)
    with pytest.raises(ValueError, match="does not cover"):
        ppm_remap_cuda(q, pe1, pe2, 1, 12)


# --- K5's merge walk and streamed profile (csrc/remap.cu), mirrored -------
#
# The kernel cannot run here, so this mirror follows its control flow per
# column in float64 scalars, on the flat arrays with the kernel's
# indexing (blocks of kThreads columns, blockIdx.y the field, field f on
# pressure face f % Fp): the edge spline into the global scratch, the
# limiter walk over a sliding window of three cells advanced when the
# merge walk reaches a source layer, and the two-pointer walk in which
# each source layer meets only the target layers that can overlap it,
# each target's terms in source-layer order.  Held against
# remap_levels_plain in float64.

KTHREADS = int(re.search(
    r"constexpr int kThreads = (\d+);",
    (Path(fv3net_tpu_torch.__file__).parent / "csrc" / "remap.cu")
    .read_text(),
).group(1))
THIRD = tremap.THIRD


def _clamp(x, lo, hi):
    return min(max(x, lo), hi)


def _mono(q, a, b):
    return _clamp(q, min(a, b), max(a, b))


def _a6(a, al, ar):
    return 3.0 * (2.0 * a - (al + ar))


def _standard_ppm(a, p):
    al, ar, a6 = p
    da1 = ar - al
    da2 = da1 * da1
    a6da = a6 * da1
    if a6da < -da2:
        a6 = 3.0 * (al - a)
        return al, al - a6, a6
    if a6da > da2:
        a6 = 3.0 * (ar - a)
        return ar - a6, ar, a6
    return p


def _cs_limiters(mode, a, p, extm):
    if mode == 1:
        if (a - p[0]) * (a - p[1]) >= 0.0:
            return a, a, 0.0
        return _standard_ppm(a, p)
    if mode == 2:
        return (a, a, 0.0) if extm else _standard_ppm(a, p)
    al, ar, a6 = p  # mode 0
    if a <= 0.0:
        return a, a, 0.0
    da1 = ar - al
    has_min = abs(da1) < -a6
    safe = 1.0 if a6 == 0.0 else a6
    fmin = a + 0.25 * da1 * da1 / safe + a6 * (1.0 / 12.0)
    if not (has_min and fmin < 0.0):
        return p
    if a < ar and a < al:
        return a, a, 0.0
    if ar > al:
        a6 = 3.0 * (al - a)
        return al, al - a6, a6
    a6 = 3.0 * (ar - a)
    return ar - a6, ar, a6


class _Column:
    """One column's strided views into the flat arrays (csrc Col)."""

    def __init__(self, g, f, col):
        km, kn, nc, fp = g["km"], g["kn"], g["ncol"], f % g["Fp"]
        self.q = (g["q1"], f * km * nc + col)
        self.p1 = (g["pe1"], fp * (km + 1) * nc + col)
        self.p2 = (g["pe2"], fp * (kn + 1) * nc + col)
        self.out = (g["q2"], f * kn * nc + col)
        self.qe = (g["qe"], f * (km + 1) * nc + col)
        self.gam = (g["gam"], f * km * nc + col)
        self.nc = nc

    def get(self, view, k):
        return view[0][view[1] + k * self.nc]

    def put(self, view, k, x):
        view[0][view[1] + k * self.nc] = x

    def a(self, k):
        return self.get(self.q, k)


def _edge(c, e, km, iv):
    raw = c.get(c.qe, e)
    if e == 1:
        return _mono(raw, c.a(0), c.a(1))
    if 2 <= e <= km - 2:
        lo, hi = c.a(e - 1), c.a(e)
        dam, dap = lo - c.a(e - 2), c.a(e + 1) - hi
        if dam * dap > 0.0:
            return _mono(raw, lo, hi)
        if dam > 0.0:
            return max(raw, min(lo, hi))
        m = min(raw, max(lo, hi))
        return max(m, 0.0) if iv == 0 else m
    if e == km - 1:
        return _mono(raw, c.a(km - 2), c.a(km - 1))
    return raw


def _cell(c, k, km, iv):
    a, al, ar = c.a(k), _edge(c, k, km, iv), _edge(c, k + 1, km, iv)
    if k in (0, km - 1):
        extm = (al - a) * (ar - a) > 0.0
    else:
        extm = (a - c.a(k - 1)) * (c.a(k + 1) - a) < 0.0
    x0, x1 = 2.0 * a - (al + ar), abs(al - ar)
    return dict(a=a, al=al, ar=ar, extm=extm, ext5=abs(x0) > x1,
                ext6=abs(3.0 * x0) > x1)


def _interior(c, k, kord, m, s, p):
    a, al, ar = s["a"], s["al"], s["ar"]
    da, da_m1 = a - c.a(k - 1), c.a(k - 1) - c.a(k - 2)
    da_p1, da_p2 = c.a(k + 1) - a, c.a(k + 2) - c.a(k + 1)
    pmp1 = a - 2.0 * da_p1
    lac1 = pmp1 + 1.5 * da_p2
    hal = _clamp(al, min(a, pmp1, lac1), max(a, pmp1, lac1))
    pmp2 = a + 2.0 * da
    lac2 = pmp2 - 1.5 * da_m1
    har = _clamp(ar, min(a, pmp2, lac2), max(a, pmp2, lac2))
    if kord == 9:
        if s["extm"] and (m["extm"] or p["extm"]):
            return a, a, 0.0
        nonmono = abs(6.0 * a - 3.0 * (al + ar)) > abs(al - ar)
        l, r = (hal, har) if nonmono else (al, ar)
        return l, r, 6.0 * a - 3.0 * (l + r)
    nb5, nb6 = m["ext5"] or p["ext5"], m["ext6"] or p["ext6"]
    l, r = al, ar
    if s["ext5"] and nb5:
        l = r = a
    elif (s["ext5"] and nb6) or (s["ext6"] and nb5):
        l, r = hal, har
    return l, r, _a6(a, l, r)


class _ProfileWalk:
    """The profiles of the source layers in order (csrc ProfileWalk)."""

    def __init__(self, c, km, iv, kord):
        self.c, self.km, self.iv, self.kord, self.k = c, km, iv, kord, -1
        self.served = []
        if kord <= 16:
            self.c0, self.cp = _cell(c, 0, km, iv), _cell(c, 1, km, iv)

    def next(self):
        c, km, iv = self.c, self.km, self.iv
        self.k += 1
        k = self.k
        self.served.append(k)
        if self.kord > 16:
            al, ar = c.get(c.qe, k), c.get(c.qe, k + 1)
            return al, ar - al, _a6(c.a(k), al, ar)
        if k > 0:
            self.cm, self.c0 = self.c0, self.cp
            if k + 1 < km:
                self.cp = _cell(c, k + 1, km, iv)
        s = self.c0
        a = s["a"]
        if k == 0:
            al = s["al"]
            if iv == 0:
                al = max(al, 0.0)
            if iv == -1 and al * a <= 0.0:
                al = 0.0
            p = _cs_limiters(1, a, (al, s["ar"], _a6(a, al, s["ar"])),
                             s["extm"])
        elif k in (1, km - 2):
            p = _cs_limiters(2, a, (s["al"], s["ar"],
                                    _a6(a, s["al"], s["ar"])), s["extm"])
        elif k == km - 1:
            ar = s["ar"]
            if iv == 0:
                ar = max(ar, 0.0)
            if iv == -1 and ar * a <= 0.0:
                ar = 0.0
            p = _cs_limiters(1, a, (s["al"], ar, _a6(a, s["al"], ar)),
                             s["extm"])
        else:
            p = _interior(c, k, self.kord, self.cm, s, self.cp)
            if iv == 0:
                p = _cs_limiters(0, a, p, s["extm"])
        return p[0], p[1] - p[0], p[2]


def _column(c, km, kn, iv, kord, stats):
    """One thread's column (csrc remap_kernel)."""
    # 1. edge spline, forward sweep into the scratch, back substitution
    p0, p1, p2 = c.get(c.p1, 0), c.get(c.p1, 1), c.get(c.p1, 2)
    dp0, dp1 = p1 - p0, p2 - p1
    grat = dp1 / dp0
    bet0 = grat * (grat + 0.5)
    q = ((grat + grat) * (grat + 1.0) * c.a(0) + c.a(1)) / bet0
    gm = (1.0 + grat * (grat + 1.5)) / bet0
    c.put(c.qe, 0, q)
    c.put(c.gam, 0, gm)
    dp_prev, dp_prev2, a_prev, pe = dp0, 0.0, c.a(0), p1
    for e in range(1, km):
        pe_next = c.get(c.p1, e + 1)
        dpe = pe_next - pe
        ae = c.a(e)
        d4 = dp_prev / dpe
        bet = 2.0 + d4 + d4 - gm
        q = (3.0 * (a_prev + d4 * ae) - q) / bet
        gm = d4 / bet
        c.put(c.qe, e, q)
        c.put(c.gam, e, gm)
        dp_prev2, dp_prev, a_prev, pe = dp_prev, dpe, ae, pe_next
    d4b = dp_prev2 / dp_prev
    a_bot = 1.0 + d4b * (d4b + 1.5)
    qn = (2.0 * d4b * (d4b + 1.0) * c.a(km - 1) + c.a(km - 2)
          - a_bot * q) / (d4b * (d4b + 0.5) - a_bot * gm)
    c.put(c.qe, km, qn)
    for e in range(km - 1, -1, -1):
        qn = c.get(c.qe, e) - c.get(c.gam, e) * qn
        c.put(c.qe, e, qn)
    # 2./3. merge walk with the streamed profile: the source layers in
    # order, each meeting the target layers that can overlap it
    walk = _ProfileWalk(c, km, iv, kord)
    top, bot = c.get(c.p1, 0), c.get(c.p1, km)
    q_top, q_bot = c.a(0), c.a(km - 1)
    pa, pb = c.get(c.p2, 0), c.get(c.p2, 1)
    pca, pcb = _clamp(pa, top, bot), _clamp(pb, top, bot)
    m, j, pk = 0.0, 0, top
    for k in range(km):
        if j == kn:
            break
        pk1 = c.get(c.p1, k + 1)
        pr = walk.next()
        dp = pk1 - pk
        dps = dp if dp > 0.0 else 1.0
        while True:
            stats["steps"] += 1
            ov = min(pcb, pk1) - max(pca, pk)
            if ov > 0.0:
                stats["pairs"] += 1
                sa = _clamp((pca - pk) / dps, 0.0, 1.0)
                sb = _clamp((pcb - pk) / dps, 0.0, 1.0)
                ss = sa + sb
                sq = sa * sa + sa * sb + sb * sb
                mean = pr[0] + 0.5 * pr[1] * ss + pr[2] * (0.5 * ss
                                                           - sq * THIRD)
                m += ov * mean
            if pcb > pk1 and k < km - 1:
                break  # target j goes on into layer k + 1
            m += q_top * (min(pb, top) - min(pa, top))
            m += q_bot * (max(pb, bot) - max(pa, bot))
            c.put(c.out, j, m / (pb - pa))
            j += 1
            if j == kn:
                break
            m, pa, pca = 0.0, pb, pcb
            pb = c.get(c.p2, j + 1)
            pcb = _clamp(pb, top, bot)
        pk = pk1
    assert j == kn, "a target layer was left unwritten"
    assert walk.served == list(range(len(walk.served)))


def remap_mirror(q1, pe1, pe2, iv, kord):
    """K5's launch over [F, km, Y, X] float64 numpy arrays."""
    F, km, Y, X = q1.shape
    Fp, kn = pe1.shape[0], pe2.shape[1] - 1
    ncol = Y * X
    g = dict(q1=q1.ravel(), pe1=pe1.ravel(), pe2=pe2.ravel(),
             q2=np.full(F * kn * ncol, np.nan),
             qe=np.empty(F * (km + 1) * ncol), gam=np.empty(F * km * ncol),
             km=km, kn=kn, ncol=ncol, Fp=Fp)
    stats = {"steps": 0, "pairs": 0, "columns": 0}
    for f in range(F):  # blockIdx.y
        for bx in range(math.ceil(ncol / KTHREADS)):  # blockIdx.x
            for tx in range(KTHREADS):
                col = bx * KTHREADS + tx
                if col >= ncol:
                    continue
                _column(_Column(g, f, col), km, kn, iv, kord, stats)
                stats["columns"] += 1
    return g["q2"].reshape(F, kn, Y, X), stats


def _mirror_inputs(seed, F=2, Fp=2, km=11, kn=9, ny=3, nx=4, case="plain"):
    """Monotone edges from positive spacings sharing the column's end
    points (chip_smoke.py's remap inputs), rounded to float32, then held
    in float64; "coincident": some target edges on source edges exactly;
    "beyond": target edges above the source top and below its bottom."""
    rng = np.random.RandomState(seed)

    def edges(k):
        w = np.cumsum(0.2 + rng.rand(Fp, k + 1, ny, nx), axis=1)
        return (w - w[:, :1]) / (w[:, -1:] - w[:, :1])

    ps = 1e5 * (1.0 + 0.02 * rng.rand(Fp, 1, ny, nx))
    pe1 = (300.0 + edges(km) * (ps - 300.0)).astype(np.float32)
    pe2 = (300.0 + edges(kn) * (ps - 300.0)).astype(np.float32)
    if case == "coincident":
        pe2[:, 2], pe2[:, 4], pe2[:, 5] = pe1[:, 2], pe1[:, 5], pe1[:, 6]
        pe2 = np.sort(pe2, axis=1)
    if case == "beyond":
        pe2 = (pe2.astype(np.float64) * 1.04 - 2500.0).astype(np.float32)
    q = (1.0 + rng.randn(F, km, ny, nx)).astype(np.float32)
    return [a.astype(np.float64) for a in (q, pe1, pe2)]


# float64 against float64: the walk adds only the overlapping layers, in
# k order, where the plain form sums all km terms with torch.sum; without
# a limiter (kord 17) the terms reach ~1e3 times the layer means, so the
# sums differ by a few 1e-13
MIRROR_RTOL = 1e-10


@pytest.mark.parametrize("stag", [(0, 0), (1, 0), (0, 1)])
@pytest.mark.parametrize("kord", [9, 10, 17])
@pytest.mark.parametrize("iv", [1, 0, -1])
def test_remap_mirror_matches_plain(iv, kord, stag):
    args = _mirror_inputs(kord + iv, ny=3 + stag[0], nx=4 + stag[1])
    got, stats = remap_mirror(*args, iv, kord)
    want = tremap.remap_levels_plain(
        *(torch.as_tensor(a) for a in args), iv, kord
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=MIRROR_RTOL,
                               atol=MIRROR_RTOL)
    km, kn = args[0].shape[1], args[2].shape[1] - 1
    # O(km + kn): with distinct interior edges every column has exactly
    # km + kn - 1 overlapping pairs, and the walk takes one step per
    # target finished and one per source layer left
    assert stats["pairs"] == stats["columns"] * (km + kn - 1)
    assert stats["steps"] <= stats["columns"] * (km + kn)


@pytest.mark.parametrize("case", ["coincident", "beyond"])
@pytest.mark.parametrize("iv,kord", [(1, 9), (0, 10), (-1, 17)])
def test_remap_mirror_edge_cases(case, iv, kord):
    """Target edges exactly on source edges (an overlap of zero width is
    skipped, as the dense form adds ov = 0), and target edges above and
    below the source column (the constant extensions), with a tracer
    stack (F > Fp) and a ragged block of columns."""
    args = _mirror_inputs(7, F=4, Fp=2, km=12, kn=10, ny=5, nx=27,
                          case=case)
    assert args[1].shape[2] * args[1].shape[3] > KTHREADS  # two blocks
    got, _ = remap_mirror(*args, iv, kord)
    want = tremap.remap_levels_plain(
        *(torch.as_tensor(a) for a in args), iv, kord
    ).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=MIRROR_RTOL,
                               atol=MIRROR_RTOL)
    if case == "coincident":
        assert np.isin(args[2], args[1]).sum() > 0
