"""fv3net_tpu_torch's fused-transport pieces against the JAX package: the
plain fv_tp_2d_multi5 against the Pallas fv_tp_2d_multi5 in interpret
mode (the inputs and tolerance of tests/test_pallas_kernels.py:287-346,
float32) and against the JAX package's five-call wiring
(dycore/hydro.py:423-452) in float64; the set_fused_transport switch;
and a numpy mirror of the K6 kernel's tiles against the plain form."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fv3net_tpu_torch
from fv3net_tpu.ops import advection as jadv
from fv3net_tpu.ops.pallas_tp import fv_tp_2d_multi5 as jmulti5
from fv3net_tpu_torch.ops import advection as tadv
from fv3net_tpu_torch.ops.cuda_tp import fv_tp_2d_multi5_cuda

torch.set_num_threads(1)

NAMES = "fxd fyd fxt fyt fxw fyw fxz fyz fxo fyo".split()


def _inputs(F=2, nz=4, N=136, seed=3, dtype=np.float32):
    """The JAX kernel test's physically scaled fields (16 [F, nz, N, N])
    and areas (2 [F, N, N])."""
    rng = np.random.RandomState(seed)

    def f(*s):
        return rng.randn(*s).astype(np.float32)

    sh = (F, nz, N, N)
    dpx, dpy = 50.0 + 2.0 * f(*sh), 50.0 + 2.0 * f(*sh)
    ptx, pty = 300.0 + 10 * f(*sh), 300.0 + 10 * f(*sh)
    wx, wy = f(*sh), f(*sh)
    dzx, dzy = -100.0 + 5 * f(*sh), -100.0 + 5 * f(*sh)
    ox, oy = 1e-4 * f(*sh), 1e-4 * f(*sh)
    crx, cry = 0.2 * f(*sh), 0.2 * f(*sh)
    apx = np.abs(f(F, N, N)) + 5.0
    apy = np.abs(f(F, N, N)) + 5.0
    xfx = 0.2 * apx[:, None] * f(*sh)
    yfx = 0.2 * apy[:, None] * f(*sh)
    sfx = 0.2 * apx[:, None] * f(*sh)
    sfy = 0.2 * apy[:, None] * f(*sh)
    return [np.asarray(a, dtype) for a in (
        dpx, dpy, ptx, pty, wx, wy, dzx, dzy, ox, oy, crx, cry, xfx, yfx,
        sfx, sfy, apx, apy,
    )]


def test_multi5_plain_matches_pallas_interpret():
    args = _inputs()
    want = jmulti5(*(jnp.asarray(a) for a in args), 5, interpret=True)
    got = tadv.fv_tp_2d_multi5_plain(*(torch.as_tensor(a) for a in args), 5)
    sl = np.s_[:, :, 2:-2, 2:-2]
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(  # test_pallas_kernels.py:341-345
            g.numpy()[sl], np.asarray(w)[sl], rtol=5e-3, atol=1e-3,
            err_msg=f"multi5 output {name}",
        )


def _jax_five_calls(args, hord):
    """The JAX package's unfused wiring of the five transports."""
    (dpx, dpy, ptx, pty, wx, wy, dzx, dzy, ox, oy, crx, cry, xfx, yfx,
     sfx, sfy, apx, apy) = (jnp.asarray(a) for a in args)
    ax, ay = apx[:, None], apy[:, None]
    fx, fy = jadv.fv_tp_2d(dpx, dpy, crx, cry, xfx, yfx, ax, ay, hord)
    out = (fx, fy)
    out += jadv.fv_tp_2d(ptx, pty, crx, cry, fx, fy, ax * dpx, ay * dpy,
                         hord)
    out += jadv.fv_tp_2d(wx, wy, crx, cry, fx, fy, ax * dpx, ay * dpy, hord)
    out += jadv.fv_tp_2d(dzx, dzy, crx, cry, xfx, yfx, ax, ay, hord)
    out += jadv.fv_tp_2d(ox, oy, crx, cry, sfx, sfy, ax, ay, hord)
    return out


@pytest.mark.parametrize("hord", [1, 5, 6, 8])
def test_multi5_plain_matches_jax_five_calls(hord):
    args = _inputs(F=6, nz=3, N=18, seed=hord, dtype=np.float64)
    want = _jax_five_calls(args, hord)
    got = tadv.fv_tp_2d_multi5_plain(*(torch.as_tensor(a) for a in args),
                                     hord)
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-12 * np.abs(w).max(), f"{name}: {err:.3e}"


@pytest.mark.parametrize("area_shape", ["FNN", "F1NN"])
def test_multi5_cpu_dispatch_is_plain_and_counts_nothing(area_shape):
    args = [torch.as_tensor(a) for a in _inputs(F=6, nz=2, N=12)]
    fv_tp_2d_multi5_cuda.launches = 0
    areas = args[16:]
    if area_shape == "F1NN":
        areas = [a[:, None] for a in areas]
    got = tadv.fv_tp_2d_multi5(*args[:16], *areas, 5)
    want = tadv.fv_tp_2d_multi5_plain(*args, 5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fv_tp_2d_multi5_cuda.launches == 0


def test_multi5_cuda_refuses():
    args = [torch.as_tensor(a) for a in _inputs(F=1, nz=1, N=8)]
    with pytest.raises(ValueError, match="CUDA"):
        fv_tp_2d_multi5_cuda(*args, 5)
    with pytest.raises(ValueError, match="hord"):
        fv_tp_2d_multi5_cuda(*args, 3)


def test_set_fused_transport_switch():
    assert tadv._fused5_enabled() is False  # the JAX package's default
    try:
        tadv.set_fused_transport(1)
        assert tadv._fused5_enabled() is True
    finally:
        tadv.set_fused_transport(False)
    assert tadv._fused5_enabled() is False


# --- K6's tile bookkeeping (csrc/tp2d_multi5.cu), mirrored in numpy -------
#
# The kernel cannot run here, so this mirror follows its control flow:
# blocks of TY x TX output tiles of one (face, level) slab, region loads
# around the tile origin with the indices taken modulo N only for a tile
# at the lattice edge, the inner half-updates of the tile and its halo,
# the outer fluxes of the tile's faces, a ragged last tile that stores
# only the faces inside the lattice, and the two launches (delp, delz and
# vorticity; then pt and w with launch A's delp fluxes and the air mass).
# The per-face arithmetic is the plain ppm_flux on the exact cells the
# kernel reads (a window that must fit inside the loaded region), so the
# mirror equals fv_tp_2d_multi5_plain bit for bit on the whole N x N
# lattice when its bookkeeping is right.  The tile and region sizes are
# read from the kernel's source.

CSRC = Path(fv3net_tpu_torch.__file__).parent / "csrc"


def _tile_constants():
    env = {}
    text = (CSRC / "tp2d_multi5.cu").read_text()
    for line in re.findall(r"^constexpr int ([^;]+);", text, re.M):
        for decl in line.split(","):
            name, expr = (s.strip() for s in decl.split("="))
            env[name] = eval(expr, {}, dict(env))  # TX + 5 and the like
    return env


K = _tile_constants()


def _load(slab, r0, c0, h, w, counts):
    """An h x w region at (r0, c0) of an N x N slab (csrc load<H, W>)."""
    N = slab.shape[-1]
    r, c = np.arange(r0, r0 + h), np.arange(c0, c0 + w)
    if r0 >= 0 and c0 >= 0 and r0 + h <= N and c0 + w <= N:
        counts["inside"] += 1
    else:
        counts["wrapped"] += 1
        r, c = r % N, c % N
    return slab[np.ix_(r, c)]


def _faces(region, axis, lo, hi, cr, hord):
    """Face averages at region faces [lo, hi) along `axis`: ppm_flux on
    the cells lo-3 .. hi+1, which must lie inside the region."""
    assert lo - 3 >= 0 and hi + 2 <= region.shape[axis], "halo too narrow"
    sub = np.take(region, np.arange(lo - 3, hi + 2), axis=axis)
    crs = np.zeros_like(sub)
    idx = [slice(None)] * 2
    idx[axis] = slice(3, 3 + hi - lo)
    crs[tuple(idx)] = cr
    out = tadv.ppm_flux(torch.as_tensor(sub), torch.as_tensor(crs), axis,
                        hord).numpy()
    return out[tuple(idx)]


def _inner(q0, area, f, m, axis):
    """inner_update along `axis` from the faces' fluxes f and mass
    fluxes m (one more face than cells)."""
    lo = [slice(None)] * 2
    hi = [slice(None)] * 2
    lo[axis], hi[axis] = slice(0, -1), slice(1, None)
    lo, hi = tuple(lo), tuple(hi)
    ra = area + (m[lo] - m[hi])
    return 0.5 * (q0 + (q0 * area + (f[lo] - f[hi])) / ra)


def _tile(qx, qy, crx, cry, mfx, mfy, apx, apy, j0, i0, hord, counts):
    """(fx, fy) of the TY x TX tile at (j0, i0) of one slab."""
    TX, TY = K["TX"], K["TY"]
    cx = _load(crx, j0 - 3, i0, K["CX_H"], K["CX_W"], counts)
    cy = _load(cry, j0, i0 - 3, K["CY_H"], K["CY_W"], counts)
    mx = _load(mfx, j0 - 3, i0, K["CX_H"], K["CX_W"], counts)
    my = _load(mfy, j0, i0 - 3, K["CY_H"], K["CY_W"], counts)
    ax = _load(apx, j0 - 3, i0, K["QX_H"], K["QX_W"], counts)
    ay = _load(apy, j0, i0 - 3, K["QY_H"], K["QY_W"], counts)
    ix = _load(qx, j0 - 3, i0 - 3, K["IX_H"], K["IX_W"], counts)
    iy = _load(qy, j0 - 3, i0 - 3, K["IY_H"], K["IY_W"], counts)
    # q_y: rows j0 .. j0+TY-1 (iy rows 3 ..), faces j0 .. j0+TY
    fy2 = _faces(iy, 0, 3, 3 + K["QY_H"] + 1, cy, hord) * my
    q_y = _inner(iy[3 : 3 + K["QY_H"]], ay, fy2, my, 0)
    # q_x: columns i0 .. i0+TX-1 (ix columns 3 ..), faces i0 .. i0+TX
    fx2 = _faces(ix, 1, 3, 3 + K["QX_W"] + 1, cx, hord) * mx
    q_x = _inner(ix[:, 3 : 3 + K["QX_W"]], ax, fx2, mx, 1)
    assert q_y.shape == (K["QY_H"], K["QY_W"])
    assert q_x.shape == (K["QX_H"], K["QX_W"])
    # outer fluxes of the tile's faces: q_y columns and q_x rows 3 ..
    fx = _faces(q_y, 1, 3, 3 + TX, cx[3 : 3 + TY, :TX], hord)
    fy = _faces(q_x, 0, 3, 3 + TY, cy[:TY, 3 : 3 + TX], hord)
    return fx * mx[3 : 3 + TY, :TX], fy * my[:TY, 3 : 3 + TX]


def _launch(fields, crx, cry, apx, apy, hord, counts):
    """One launch over every slab (blockIdx.z) and tile: fields [(qx, qy,
    mfx, mfy, fx out, fy out)] in turn; areas [F, nz, N, N]."""
    TX, TY = K["TX"], K["TY"]
    F, nz, N, _ = crx.shape
    for f in range(F):
        for k in range(nz):
            for j0 in range(0, N, TY):  # blockIdx.y
                for i0 in range(0, N, TX):  # blockIdx.x
                    for qx, qy, mfx, mfy, ox, oy in fields:
                        fx, fy = _tile(
                            qx[f, k], qy[f, k], crx[f, k], cry[f, k],
                            mfx[f, k], mfy[f, k], apx[f, k], apy[f, k],
                            j0, i0, hord, counts,
                        )
                        h, w = min(TY, N - j0), min(TX, N - i0)  # ragged
                        ox[f, k, j0 : j0 + h, i0 : i0 + w] = fx[:h, :w]
                        oy[f, k, j0 : j0 + h, i0 : i0 + w] = fy[:h, :w]


def multi5_tiled_mirror(dpx, dpy, ptx, pty, wx, wy, dzx, dzy, ox, oy, crx,
                        cry, xfx, yfx, sfx, sfy, apx, apy, hord):
    out = [np.full(dpx.shape, np.nan) for _ in range(10)]
    fxd, fyd, fxt, fyt, fxw, fyw, fxz, fyz, fxo, fyo = out
    counts = {"inside": 0, "wrapped": 0}
    ax, ay = (np.broadcast_to(a[:, None], dpx.shape) for a in (apx, apy))
    # launch A: delp, delz and the vorticity
    _launch([(dpx, dpy, xfx, yfx, fxd, fyd), (dzx, dzy, xfx, yfx, fxz, fyz),
             (ox, oy, sfx, sfy, fxo, fyo)], crx, cry, ax, ay, hord, counts)
    # launch B: pt and w with A's delp fluxes and the air mass area * delp
    _launch([(ptx, pty, fxd, fyd, fxt, fyt), (wx, wy, fxd, fyd, fxw, fyw)],
            crx, cry, ax * dpx, ay * dpy, hord, counts)
    return out, counts


@pytest.mark.parametrize("N,hord,F,nz", [
    (18, 5, 2, 2),  # smaller than one tile: every load wraps
    (40, 8, 2, 1),  # ragged last tiles in x and y
    (54, 6, 1, 2),  # the C48 width, ragged
    (80, 5, 1, 1),  # interior tiles that load without wrapping
    (40, 1, 1, 1),
])
def test_multi5_tiled_mirror_equals_plain_on_whole_lattice(N, hord, F, nz):
    """The mirror of K6's tiles equals the plain form on every face of the
    padded lattice, halo faces included, bit for bit in float64: same
    arithmetic on the same cells, so any error in a tile origin, a region
    width, a wrapped load or the ragged edge would show."""
    args = _inputs(F=F, nz=nz, N=N, seed=N + hord, dtype=np.float64)
    got, counts = multi5_tiled_mirror(*args, hord)
    want = tadv.fv_tp_2d_multi5_plain(*(torch.as_tensor(a) for a in args),
                                      hord)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    assert counts["wrapped"] > 0
    if N >= 80:
        assert counts["inside"] > 0


def test_multi5_tile_regions_cover_the_stencil():
    """The region widths in the kernel are exactly the stencil's reach:
    the face average reads cells i-3 .. i+2 (tp2d_core.cuh), so the
    half-updates span the tile plus 3 + 2 and the inner input the tile
    plus 3 + 3 along the transported direction."""
    TX, TY = K["TX"], K["TY"]
    assert (K["QY_H"], K["QY_W"]) == (TY, TX + 5)
    assert (K["IY_H"], K["IY_W"]) == (TY + 6, TX + 5)
    assert (K["CY_H"], K["CY_W"]) == (TY + 1, TX + 5)
    assert (K["QX_H"], K["QX_W"]) == (TY + 5, TX)
    assert (K["IX_H"], K["IX_W"]) == (TY + 5, TX + 6)
    assert (K["CX_H"], K["CX_W"]) == (TY + 5, TX + 1)
    # launch A's tiles: Courant numbers, two flux pairs and the face
    # fluxes on the face regions; areas and half-updates on the cell
    # regions; the field's two fillings -- within the 48 KB of static
    # shared memory a block may have
    faces = K["CX_H"] * K["CX_W"] + K["CY_H"] * K["CY_W"]
    cells = K["QX_H"] * K["QX_W"] + K["QY_H"] * K["QY_W"]
    fields = K["IX_H"] * K["IX_W"] + K["IY_H"] * K["IY_W"]
    assert 4 * (4 * faces + 2 * cells + fields) <= 48 * 1024
