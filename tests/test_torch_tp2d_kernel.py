"""K1 (csrc/tp2d.cu) on the CPU: a numpy mirror of the kernel's tiles,
its 8-byte pair layout, its two-stage ring over a run of levels and its
in-place half-updates, held bit for bit against the plain fv_tp_2d on the
whole padded lattice (float64), which tests/test_torch_advection.py holds
against the JAX package; the wrapper's level runs; and the sources of the
design variants kernel_variants.py builds."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fv3net_tpu_torch
from fv3net_tpu.ops import advection as jadv
from fv3net_tpu_torch.ops import advection as tadv
from fv3net_tpu_torch import kernel_variants
from fv3net_tpu_torch.ops import _build, cuda_tp
from test_torch_multi5 import _faces, _inner

torch.set_num_threads(1)

CSRC = Path(fv3net_tpu_torch.__file__).parent / "csrc"


def pair_stride(w):
    return (w + 2) & ~1  # csrc/tile.cuh


def _align4(x):
    return (x + 3) & ~3  # csrc/tp2d.cu


def _constants():
    """The kernel's integer constants (tile, regions, shared-memory
    layout in floats), evaluated from its source."""
    env = {}
    fns = {"pair_stride": pair_stride, "align4": _align4}
    text = (CSRC / "tp2d.cu").read_text()
    for line in re.findall(r"^constexpr int ([A-Z][^;]*);", text, re.M):
        for decl in line.split(", "):
            name, expr = (s.strip() for s in decl.split("=", 1))
            if "sizeof" not in expr:
                env[name] = eval(expr, fns, dict(env))
    return env


K = _constants()


def _load(slab, r0, c0, h, w, pairs, counts):
    """An h x w region at (r0, c0) of an N x N slab as csrc/tile.cuh's
    load_tile_pairs lays it out: rows of pair_stride(w), element (r, c) at
    column c + (c0 & 1) with pairs (8-byte copies from the even column at
    or before c0), at c without.  Returns the view of the region."""
    N = slab.shape[-1]
    S = pair_stride(w)
    dst = np.full((h, S), np.nan)
    if pairs:
        off = c0 & 1
        cs = c0 - off
        cols = cs + np.arange(S)
        assert N % 2 == 0 and cs % 2 == 0  # aligned pairs, never split
    else:
        off, cs = 0, c0
        cols = c0 + np.arange(w)
    rows = r0 + np.arange(h)
    if r0 >= 0 and cs >= 0 and r0 + h <= N and cs + len(cols) <= N:
        counts["inside"] += 1
    else:
        counts["wrapped"] += 1
        rows, cols = rows % N, cols % N
    dst[:, : len(cols)] = slab[np.ix_(rows, cols)]
    return dst[:, off : off + w]


def tp2d_tiled_mirror(qx, qy, crx, cry, xfx, yfx, apx, apy, hord, lv,
                      pairs):
    """fx, fy of K1 over every block: face, run of lv levels, tile."""
    TX, TY = K["TX"], K["TY"]
    F, nz, N, _ = qx.shape
    plain = apx.shape[1] == 1
    fx, fy = np.full(qx.shape, np.nan), np.full(qx.shape, np.nan)
    counts = {"inside": 0, "wrapped": 0, "area_loads": 0}
    runs = -(-nz // lv)
    for f in range(F):
        for run in range(runs):  # blockIdx.z = f * runs + run
            k0, k1 = run * lv, min(run * lv + lv, nz)
            for j0 in range(0, N, TY):  # blockIdx.y
                for i0 in range(0, N, TX):  # blockIdx.x
                    stages = [{}, {}]

                    def issue(k, st, areas):
                        def ld(a, r0, c0, h, w):
                            return _load(a[f, k], r0, c0, h, w, pairs,
                                         counts)

                        s = stages[st]
                        s["ix"] = ld(qx, j0 - 3, i0 - 3, K["IX_H"], K["IX_W"])
                        s["iy"] = ld(qy, j0 - 3, i0 - 3, K["IY_H"], K["IY_W"])
                        s["cx"] = ld(crx, j0 - 3, i0, K["CX_H"], K["CX_W"])
                        s["mx"] = ld(xfx, j0 - 3, i0, K["CX_H"], K["CX_W"])
                        s["cy"] = ld(cry, j0, i0 - 3, K["CY_H"], K["CY_W"])
                        s["my"] = ld(yfx, j0, i0 - 3, K["CY_H"], K["CY_W"])
                        if areas:
                            ka = 0 if plain else k
                            s["ax"] = _load(apx[f, ka], j0 - 3, i0, K["QX_H"],
                                            K["QX_W"], pairs, counts)
                            s["ay"] = _load(apy[f, ka], j0, i0 - 3, K["QY_H"],
                                            K["QY_W"], pairs, counts)
                            counts["area_loads"] += 1

                    issue(k0, 0, True)
                    for k in range(k0, k1):
                        st = (k - k0) & 1
                        if k + 1 < k1:
                            issue(k + 1, st ^ 1, not plain or k + 1 - k0 < 2)
                        s = stages[st]
                        ix, iy = s["ix"], s["iy"]
                        cx, mx, cy, my = s["cx"], s["mx"], s["cy"], s["my"]
                        # inner face fluxes: y faces of qy rows 3 ..,
                        # x faces of qx columns 3 ..
                        fy2 = _faces(iy, 0, 3, 3 + K["CY_H"], cy, hord) * my
                        fx2 = _faces(ix, 1, 3, 3 + K["CX_W"], cx, hord) * mx
                        # half-updates written over their own input cells
                        iy[3 : 3 + K["QY_H"]] = _inner(
                            iy[3 : 3 + K["QY_H"]], s["ay"], fy2, my, 0)
                        ix[:, 3 : 3 + K["QX_W"]] = _inner(
                            ix[:, 3 : 3 + K["QX_W"]], s["ax"], fx2, mx, 1)
                        # outer fluxes of the tile's faces
                        ox = _faces(iy[3 : 3 + TY], 1, 3, 3 + TX,
                                    cx[3 : 3 + TY, :TX], hord)
                        oy = _faces(ix[:, 3 : 3 + TX], 0, 3, 3 + TY,
                                    cy[:TY, 3 : 3 + TX], hord)
                        ox = ox * mx[3 : 3 + TY, :TX]
                        oy = oy * my[:TY, 3 : 3 + TX]
                        h, w = min(TY, N - j0), min(TX, N - i0)  # ragged
                        fx[f, k, j0 : j0 + h, i0 : i0 + w] = ox[:h, :w]
                        fy[f, k, j0 : j0 + h, i0 : i0 + w] = oy[:h, :w]
    return fx, fy, counts


def _inputs(F, nz, N, mass, seed):
    """Physically scaled fields (Courant numbers ~0.2, fluxes ~5% of the
    cell area, chip_smoke.py's K1 inputs), float64."""
    rng = np.random.RandomState(seed)
    sh = (F, nz, N, N)
    area = 1.0 + 0.1 * rng.rand(F, 1, N, N)
    args = [rng.randn(*sh), rng.randn(*sh), 0.2 * rng.randn(*sh),
            0.2 * rng.randn(*sh), 0.05 * area * rng.randn(*sh),
            0.05 * area * rng.randn(*sh)]
    if mass:
        dp = 100.0 + rng.rand(*sh)
        args += [area * dp, (area + 0.01) * dp]
    else:
        args += [area, area + 0.01]
    return args


@pytest.mark.parametrize("mass", [False, True])
@pytest.mark.parametrize("N,hord,F,nz,lv", [
    (11, 5, 2, 3, 2),  # odd N: 4-byte copies; smaller than one tile
    (18, 1, 1, 5, 4),  # even N: pairs; two runs, the second of one level
    (40, 6, 1, 4, 3),  # ragged last tiles in x and y
    (54, 8, 1, 2, 2),  # the C48 width
    (80, 5, 1, 1, 1),  # interior tiles: no region of theirs wraps
])
def test_tp2d_tiled_mirror_equals_plain_on_whole_lattice(N, hord, F, nz, lv,
                                                         mass):
    """The mirror of K1's tiles equals the plain form on every face of the
    padded lattice, halo faces included, bit for bit in float64: any error
    in a tile origin, a region, the pair layout, a ring stage, a plain
    area tile reused from an earlier level, the in-place half-updates or
    the ragged edge would show."""
    args = _inputs(F, nz, N, mass, seed=N + hord)
    fx, fy, counts = tp2d_tiled_mirror(*args, hord, lv, pairs=N % 2 == 0)
    want = tadv.fv_tp_2d_plain(*(torch.as_tensor(a) for a in args), hord)
    np.testing.assert_array_equal(fx, want[0].numpy())
    np.testing.assert_array_equal(fy, want[1].numpy())
    assert counts["wrapped"] > 0
    assert (counts["inside"] > 0) == (N >= 40)  # a tile within reach
    tiles = -(-N // K["TX"]) * -(-N // K["TY"])
    runs = -(-nz // lv)
    # plain areas: copied for the first two levels of a run only
    per_run = [min(lv, nz - r * lv) for r in range(runs)]
    want_loads = sum(n if mass else min(n, 2) for n in per_run)
    assert counts["area_loads"] == F * tiles * want_loads


def test_tp2d_tiled_mirror_without_pairs_and_against_jax():
    """The 4-byte layout on an even N (a slab not 8-byte aligned) gives the
    same fluxes, and the mirror agrees with the JAX package's fv_tp_2d on
    the faces the caller consumes."""
    N, hord = 18, 5
    args = _inputs(2, 3, N, False, seed=3)
    fx, fy, _ = tp2d_tiled_mirror(*args, hord, 2, pairs=False)
    want = tadv.fv_tp_2d_plain(*(torch.as_tensor(a) for a in args), hord)
    np.testing.assert_array_equal(fx, want[0].numpy())
    np.testing.assert_array_equal(fy, want[1].numpy())
    jfx, jfy = jadv.fv_tp_2d(*(jnp.asarray(a) for a in args), hord)
    sl = np.s_[:, :, 2 : N - 2, 2 : N - 2]
    np.testing.assert_allclose(fx[sl], np.asarray(jfx)[sl], rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(fy[sl], np.asarray(jfy)[sl], rtol=1e-12,
                               atol=1e-12)


def test_tp2d_tile_regions_and_shared_memory():
    """The regions are the stencil's reach (as K6's), the wrapper's tile
    is the kernel's, and two stages of the inputs plus the face fluxes
    leave room for the blocks an SM that the kernel's launch bounds ask
    for (227 KB a block, 228 KB an SM, 1 KB of it reserved per block)."""
    TX, TY = K["TX"], K["TY"]
    assert (cuda_tp.TX, cuda_tp.TY) == (TX, TY)
    assert (K["QY_H"], K["QY_W"]) == (TY, TX + 5)
    assert (K["IY_H"], K["IY_W"]) == (TY + 6, TX + 5)
    assert (K["CY_H"], K["CY_W"]) == (TY + 1, TX + 5)
    assert (K["QX_H"], K["QX_W"]) == (TY + 5, TX)
    assert (K["IX_H"], K["IX_W"]) == (TY + 5, TX + 6)
    assert (K["CX_H"], K["CX_W"]) == (TY + 5, TX + 1)

    stage = (_align4(K["IX_H"] * pair_stride(K["IX_W"]))
             + _align4(K["IY_H"] * pair_stride(K["IY_W"]))
             + 2 * _align4(K["CX_H"] * pair_stride(K["CX_W"]))
             + 2 * _align4(K["CY_H"] * pair_stride(K["CY_W"]))
             + _align4(K["QX_H"] * pair_stride(K["QX_W"]))
             + _align4(K["QY_H"] * pair_stride(K["QY_W"])))
    assert K["STAGE"] == stage
    assert K["SMEM_FLOATS"] == 2 * stage + _align4(
        K["CX_H"] * K["CX_W"]) + _align4(K["CY_H"] * K["CY_W"])
    total = 4 * K["SMEM_FLOATS"]
    text = (CSRC / "tp2d.cu").read_text()
    blocks = int(re.search(r"__launch_bounds__\(kThreads, (\d+)\)",
                           text).group(1))
    assert blocks * (total + 1024) <= 228 * 1024
    assert total > 48 * 1024  # hence dynamic shared memory


def test_tp2d_levels_per_block():
    # C192 x 63: 66 tiles a slab -> runs of 8 levels; C48: 6 tiles -> 1
    tiles = [-(-N // cuda_tp.TX) * -(-N // cuda_tp.TY) for N in (198, 54)]
    assert tiles == [66, 6]
    assert _build.levels_per_block(66, 6 * 63) == 8
    assert _build.levels_per_block(6, 6 * 63) == 1
    assert _build.levels_per_block(6, 6 * 200) == 3


@pytest.mark.parametrize("name", list(kernel_variants.K1_VARIANTS))
def test_kernel_variants_sources(name):
    """Each design variant of K1 (fv3net_tpu_torch/kernel_variants.py)
    is the kernel's source with its tile, threads, blocks and mode
    changed; the first is the package's own kernel."""
    src = (CSRC / "tp2d.cu").read_text()
    tx, ty, threads, blocks, mode = kernel_variants.K1_VARIANTS[name]
    out = kernel_variants.variant_source(src, tx, ty, threads, blocks, mode)
    assert f"constexpr int TX = {tx};" in out
    assert f"constexpr int TY = {ty};" in out
    assert f"constexpr int kThreads = {threads};" in out
    assert f"__launch_bounds__(kThreads, {blocks})" in out
    assert (out.count("if (false) for") == 5) == (mode == "copies")
    assert ("    if (false)\n      issue(" in out) == (mode == "phases")
    assert ("bool pairs = false;" in out) == (mode == "four_byte")
    if name == next(iter(kernel_variants.K1_VARIANTS)):
        assert (tx, ty, mode) == (K["TX"], K["TY"], "full")
        assert out == src
    with pytest.raises(ValueError, match="no"):
        kernel_variants.variant_source("", tx, ty, threads, blocks, mode)
