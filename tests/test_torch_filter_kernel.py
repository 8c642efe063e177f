"""K3 (csrc/filter.cu) on the CPU: the int32 gather tables it reads its
operands through (grid/halo.py::scalar_gather_flat) against halo_exchange,
the wrapper's refusals, and a numpy mirror of the kernel's tiles, level
runs and table gathers against the plain scalar_filter and the JAX
package's jnp scalar_filter, float64."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fv3net_tpu_torch
from fv3net_tpu.dycore import sw as jsw
from fv3net_tpu.grid import CubedSphereGrid as JGrid
from fv3net_tpu_torch.convert import metrics_from_numpy
from fv3net_tpu_torch.dycore import sw as tsw
from fv3net_tpu_torch.grid import CubedSphereGrid, halo_exchange
from fv3net_tpu_torch.grid.halo import scalar_gather_flat
from fv3net_tpu_torch.ops import _build, cuda_filter
from fv3net_tpu_torch.ops.cuda_filter import del4_filter_cuda
from torch_parity import jax_metrics_arrays

torch.set_num_threads(1)

H = 3
CPU = torch.device("cpu")


@pytest.mark.parametrize("fill", ["x", "y"])
@pytest.mark.parametrize("n,nz", [(6, 1), (12, 3), (5, 2)])
def test_flat_tables_reproduce_halo_exchange(n, nz, fill):
    """q.reshape(-1)[table[f, p] + k n^2] is halo_exchange(q, h, fill) at
    slot (f, k, p), bit for bit, corner slots included."""
    q = torch.as_tensor(np.random.RandomState(n + nz).randn(6, nz, n, n))
    tab = scalar_gather_flat(n, H, nz, fill, CPU)
    N = n + 2 * H
    assert tab.dtype == torch.int32 and tab.shape == (6, N * N)
    k = torch.arange(nz).view(1, nz, 1) * n * n
    got = q.reshape(-1)[tab.long()[:, None, :] + k].reshape(6, nz, N, N)
    assert torch.equal(got, halo_exchange(q, H, fill=fill))


def test_flat_tables_refuse_int32_overflow():
    with pytest.raises(ValueError, match="int32"):
        scalar_gather_flat(192, H, 10 ** 4, "x", CPU)


def test_del4_wrapper_refuses():
    q = torch.zeros(6, 2, 6, 6)
    a = torch.ones(6, 12, 12)
    with pytest.raises(ValueError, match="halo >= 2"):
        del4_filter_cuda(q, a, a, 0.02, 1)
    with pytest.raises(ValueError, match="int32"):  # no memory behind it
        del4_filter_cuda(torch.zeros(1).expand(6, 7000, 240, 240), a, a,
                         0.02, H)
    with pytest.raises(ValueError, match="6 cube faces"):
        del4_filter_cuda(q[:3], a, a, 0.02, H)
    with pytest.raises(ValueError, match="CUDA"):
        del4_filter_cuda(q, a, a, 0.02, H)


def test_levels_per_block():
    # C192 x 63: 4 x 12 tiles a face; C48: 1 x 3; never more than 8
    tiles = [-(-n // cuda_filter.TX) * -(-n // cuda_filter.TY)
             for n in (192, 48)]
    assert tiles == [48, 3]
    assert _build.levels_per_block(48, 6 * 63) == 8
    assert _build.levels_per_block(3, 6 * 63) == 1
    assert _build.levels_per_block(48, 6) == 1


# --- K3's tiles (csrc/filter.cu), mirrored in numpy -------------------------
#
# The kernel cannot run here, so this mirror follows its control flow:
# blocks of TY x TX interior outputs of one face and a run of `lv` levels;
# the qx / qy load regions gathered through the x / y tables (positions
# computed instead for a tile whose region is interior), clamped to N-1
# for a ragged last tile; face weights with the doubling at faces h and
# h+n; L(q) on the tile and its ring, then L(L(q)) and the update, storing
# only the outputs inside the face.  The tile and region sizes are read
# from the kernel's source.

CSRC = Path(fv3net_tpu_torch.__file__).parent / "csrc"


def _constants(name):
    env = {}
    text = (CSRC / name).read_text()
    for line in re.findall(r"^constexpr int ([^;(]+);", text, re.M):
        for decl in line.split(","):
            key, expr = (s.strip() for s in decl.split("="))
            env[key] = eval(expr, {}, dict(env))
    return env


K = _constants("filter.cu")


def del4_tiled_mirror(q, apx, apy, c, h, lv):
    F, nz, n, _ = q.shape
    N = n + 2 * h
    TX, TY = K["TX"], K["TY"]
    L_H, L_W = K["L_H"], K["L_W"]
    tabs = [scalar_gather_flat(n, h, nz, fill, CPU).numpy().reshape(6, N, N)
            for fill in ("x", "y")]
    flat = q.reshape(-1)
    out = np.full(q.shape, np.nan)
    counts = {"interior": 0, "tables": 0}
    runs = -(-nz // lv)
    for f in range(F):
        for run in range(runs):  # blockIdx.z = f * runs + run
            k0, k1 = run * lv, min(run * lv + lv, nz)
            for j0 in range(0, n, TY):  # blockIdx.y
                for i0 in range(0, n, TX):  # blockIdx.x
                    J0, I0 = j0 + h, i0 + h
                    interior = (j0 >= 2 and i0 >= 2 and j0 + TY + 2 <= n
                                and i0 + TX + 2 <= n)
                    counts["interior" if interior else "tables"] += 1

                    def positions(tab, r0, c0, hh, ww):
                        r = np.arange(r0, r0 + hh)[:, None]
                        cc = np.arange(c0, c0 + ww)[None, :]
                        if interior:
                            return f * nz * n * n + (r - h) * n + (cc - h)
                        return tab[f][np.minimum(r, N - 1),
                                      np.minimum(cc, N - 1)]

                    ix = positions(tabs[0], J0 - 1, I0 - 2, K["QX_H"],
                                   K["QX_W"])
                    iy = positions(tabs[1], J0 - 2, I0 - 1, K["QY_H"],
                                   K["QY_W"])
                    J = np.minimum(J0 - 1 + np.arange(K["WX_H"]), N - 1)
                    I = I0 - 1 + np.arange(K["WX_W"])
                    Ic = np.minimum(I, N - 1)
                    dbl = np.where((I == h) | (I == h + n), 2.0, 1.0)
                    wx = 0.5 * (apx[f][J[:, None], Ic]
                                + apx[f][J[:, None], Ic - 1]) * dbl
                    J = J0 - 1 + np.arange(K["WY_H"])
                    Jc = np.minimum(J, N - 1)
                    I = np.minimum(I0 - 1 + np.arange(K["WY_W"]), N - 1)
                    dbl = np.where((J == h) | (J == h + n), 2.0, 1.0)[:, None]
                    wy = 0.5 * (apy[f][Jc[:, None], I]
                                + apy[f][Jc[:, None] - 1, I]) * dbl
                    J = np.minimum(J0 - 1 + np.arange(L_H), N - 1)
                    I = np.minimum(I0 - 1 + np.arange(L_W), N - 1)
                    ra = 1.0 / apx[f][J[:, None], I]
                    assert wx.shape == (L_H, L_W + 1)
                    assert wy.shape == (L_H + 1, L_W)
                    for k in range(k0, k1):
                        qa = flat[ix + k * n * n]
                        qb = flat[iy + k * n * n]
                        assert qa.shape == (L_H, L_W + 2)
                        assert qb.shape == (L_H + 2, L_W)
                        tx0 = wx[:, :-1] * (qa[:, 1:-1] - qa[:, :-2])
                        tx1 = wx[:, 1:] * (qa[:, 2:] - qa[:, 1:-1])
                        ty0 = wy[:-1] * (qb[1:-1] - qb[:-2])
                        ty1 = wy[1:] * (qb[2:] - qb[1:-1])
                        l1 = ra * ((tx0 - tx1) + (ty0 - ty1))
                        t, ct = np.s_[1 : TY + 1], np.s_[1 : TX + 1]
                        tx0 = wx[t, 1 : TX + 1] * (l1[t, ct] - l1[t, :TX])
                        tx1 = wx[t, 2 : TX + 2] * (l1[t, 2:] - l1[t, ct])
                        ty0 = wy[t, ct] * (l1[t, ct] - l1[:TY, ct])
                        ty1 = wy[2 : TY + 2, ct] * (l1[2:, ct] - l1[t, ct])
                        l2 = ra[t, ct] * ((tx0 - tx1) + (ty0 - ty1))
                        res = qa[t, 2 : TX + 2] - (c / 8.0) * l2
                        hh, ww = min(TY, n - j0), min(TX, n - i0)  # ragged
                        out[f, k, j0 : j0 + hh, i0 : i0 + ww] = res[:hh, :ww]
    return out, counts


def _metrics(n):
    return tsw.SWMetrics.make(CubedSphereGrid.make(n, halo=H),
                              torch.float64, device="cpu")


@pytest.mark.parametrize("n,nz,lv", [
    (6, 3, 1),    # C6: one ragged tile a face, every cube corner in it
    (12, 5, 2),   # C12 with level runs of 2 (the last run shorter)
    (12, 1, 8),   # the 3-D (one level) case, a run longer than nz
    (100, 1, 1),  # several tiles a face, one whose region is interior
])
def test_del4_tiled_mirror_equals_plain(n, nz, lv):
    """The mirror of K3's tiles equals scalar_filter_plain (both L
    applications exchanged) to 1e-12 in float64: any error in a tile
    origin, a region, a table slot (corner slots differ between the x and
    y fill and are consumed), a weight or the ragged edge would show."""
    m = _metrics(n)
    q = np.random.RandomState(n + nz).randn(6, nz, n, n)
    got, counts = del4_tiled_mirror(q, m.area_px.numpy(), m.area_py.numpy(),
                                    tsw.FILTER_COEF, H, lv)
    want = tsw.scalar_filter_plain(torch.as_tensor(q), m,
                                   tsw.FILTER_COEF).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert counts["tables"] > 0
    assert (counts["interior"] > 0) == (n >= 100)


def test_del4_tiled_mirror_matches_jax():
    """The mirror against the JAX package's jnp scalar_filter at C12."""
    n = 12
    mj = jsw.SWMetrics.make(JGrid.make(n, halo=H), jnp.float64)
    mt = metrics_from_numpy(jax_metrics_arrays(mj), "cpu")
    q = np.random.RandomState(4).randn(6, 4, n, n)
    want = np.asarray(jsw.scalar_filter(jnp.asarray(q), mj, 0.02))
    got, _ = del4_tiled_mirror(q, mt.area_px.numpy(), mt.area_py.numpy(),
                               0.02, H, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_del4_tile_regions_cover_the_stencil():
    """The regions are exactly the stencil's reach (an output reads L(q)
    at +-1, which reads q at +-2), the wrapper's tile is the kernel's, and
    the block's tiles fit the 48 KB of static shared memory."""
    TX, TY = K["TX"], K["TY"]
    assert (cuda_filter.TX, cuda_filter.TY) == (TX, TY)
    assert (K["QX_H"], K["QX_W"]) == (TY + 2, TX + 4)
    assert (K["QY_H"], K["QY_W"]) == (TY + 4, TX + 2)
    assert (K["L_H"], K["L_W"]) == (TY + 2, TX + 2)
    assert (K["WX_H"], K["WX_W"]) == (TY + 2, TX + 3)
    assert (K["WY_H"], K["WY_W"]) == (TY + 3, TX + 2)
    ring = 2 * (K["QX_H"] * K["QX_W"] + K["QY_H"] * K["QY_W"])
    tables = K["QX_H"] * K["QX_W"] + K["QY_H"] * K["QY_W"]
    weights = K["WX_H"] * K["WX_W"] + K["WY_H"] * K["WY_W"]
    assert 4 * (ring + tables + weights + 2 * K["L_H"] * K["L_W"]) <= 48 * 1024
