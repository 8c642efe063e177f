"""fv3net_tpu_torch's CUDA kernels against their plain torch versions on
the card (float32, C12 widths).  Skipped where there is no GPU; on the
GPU machine (no JAX there, so without tests/conftest.py) run
`python -m pytest tests/test_torch_cuda.py -q --noconftest`."""

import numpy as np
import pytest
import torch

from fv3net_tpu_torch import probe
from fv3net_tpu_torch.dycore import riemann, sw
from fv3net_tpu_torch.grid import halo_exchange
from fv3net_tpu_torch.ops import advection, cuda_column, remap
from fv3net_tpu_torch.ops.cuda_remap import ppm_remap_cuda
from fv3net_tpu_torch.ops.cuda_sim1 import sim1_solver_cuda
from fv3net_tpu_torch.ops.cuda_tp import fv_tp_2d_cuda, fv_tp_2d_multi5_cuda

pytestmark = pytest.mark.cuda

n, H, NZ = 12, 3, 63
N = n + 2 * H


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a, dev):
    return torch.as_tensor(np.asarray(a, np.float32), device=dev)


@pytest.mark.parametrize("mass_weighted", [False, True])
@pytest.mark.parametrize("hord", [1, 5, 6, 8])
def test_fv_tp_2d_kernel(dev, hord, mass_weighted):
    rng = np.random.RandomState(hord)
    sh = (6, NZ, N, N)
    area = 1.0 + 0.1 * rng.rand(6, 1, N, N)
    args = [rng.randn(*sh), rng.randn(*sh), 0.2 * rng.randn(*sh),
            0.2 * rng.randn(*sh), 0.05 * area * rng.randn(*sh),
            0.05 * area * rng.randn(*sh)]
    if mass_weighted:
        dp = 100.0 + rng.rand(*sh)
        args += [area * dp, area * dp]
    else:
        args += [area, area]
    args = [_t(a, dev) for a in args]
    got = advection.fv_tp_2d(*args, hord)
    want = advection.fv_tp_2d_plain(*args, hord)
    sl = np.s_[:, :, 2 : N - 2, 2 : N - 2]
    for g, w in zip(got, want):  # the JAX kernel test's tolerance
        torch.testing.assert_close(g[sl], w[sl], rtol=1e-4, atol=1e-3)


def test_sim1_kernel(dev):
    rng = np.random.RandomState(0)
    pe = np.sort(np.linspace(300.0, 1e5, NZ + 1)[:, None, None]
                 * (1.0 + 0.01 * rng.rand(6, NZ + 1, n, n)), axis=1)
    delp = pe[:, 1:] - pe[:, :-1]
    pt = np.clip(300.0 + 30.0 * rng.randn(6, NZ, n, n), 200.0, 400.0)
    tt = torch.as_tensor
    pm = riemann.layer_mean_pressure(tt(delp), tt(pe)).numpy()
    dz = riemann.hydrostatic_dz(tt(delp), tt(pt), tt(pe)).numpy()
    args = [_t(a, dev) for a in (delp / 9.80665, pt, dz,
                                 2.0 * rng.randn(6, NZ, n, n), pe, pm,
                                 0.5 * rng.randn(6, n, n))]
    got = sim1_solver_cuda(150.0, *args)
    want = riemann.sim1_solver(150.0, *args)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4,
                               atol=float(want[2].abs().max()) * 1e-4)


def test_filter_and_column_kernels(dev):
    rng = np.random.RandomState(1)
    area = _t(1.0 + 0.1 * rng.rand(6, n, n), dev)
    m = type("M", (), dict(
        n=n, halo=H, area_px=halo_exchange(area, H, fill="x"),
        area_py=halo_exchange(area, H, fill="y"), rarea=1.0 / area,
    ))
    q = _t(rng.randn(6, NZ, n, n), dev)
    torch.testing.assert_close(sw.scalar_filter(q, m, 0.02),
                               sw.scalar_filter_plain(q, m, 0.02),
                               rtol=1e-4, atol=1e-5)
    dp = _t(900.0 + 200.0 * rng.rand(6, NZ, N, N), dev)
    got = cuda_column.column_pressures(dp, 300.0)
    want = cuda_column.column_pressures_plain(dp, 300.0)
    for g, w, rtol in zip(got, want, (1e-6, 1e-5, 1e-5)):
        torch.testing.assert_close(g, w, rtol=rtol, atol=0.0)


@pytest.mark.parametrize("stag", [(0, 0), (1, 0), (0, 1)])
@pytest.mark.parametrize("iv,kord", [(1, 9), (0, 9), (-1, 9), (1, 10),
                                     (1, 17)])
def test_remap_kernel(dev, iv, kord, stag):
    rng = np.random.RandomState(kord + iv)
    ny, nx = n + stag[0], n + stag[1]

    def edges():  # monotone, with positive spacings (chip_smoke.py)
        w = np.cumsum(0.2 + rng.rand(6, NZ + 1, ny, nx), axis=1)
        return 300.0 + (w - w[:, :1]) / (w[:, -1:] - w[:, :1]) * 9.97e4

    pe1, pe2 = edges(), edges()
    q, pe1, pe2 = (_t(a, dev) for a in (1.0 + rng.randn(6, NZ, ny, nx),
                                        pe1, pe2))
    got = remap.remap_levels(q, pe1, pe2, iv, kord)
    want = remap.remap_levels_plain(q, pe1, pe2, iv, kord)
    # the JAX kernel test's tolerance (test_pallas_kernels.py:228)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    m1 = (q.double() * (pe1[:, 1:] - pe1[:, :-1]).double()).sum(1)
    m2 = (got.double() * (pe2[:, 1:] - pe2[:, :-1]).double()).sum(1)
    mp = (want.double() * (pe2[:, 1:] - pe2[:, :-1]).double()).sum(1)
    rel = float((m2 / m1 - 1.0).abs().max())
    assert rel <= 2e-4 + 2.0 * float((mp / m1 - 1.0).abs().max())
    # a tracer stack against one pressure grid is one launch
    stack = torch.cat([q, 2.0 * q])
    ppm_remap_cuda.launches = 0
    got2 = remap.remap_levels(stack, pe1, pe2, iv, kord)
    assert ppm_remap_cuda.launches == 1
    assert torch.equal(got2[:6], got)


@pytest.mark.parametrize("hord", [1, 5, 6, 8])
def test_multi5_kernel(dev, hord):
    rng = np.random.RandomState(hord)
    sh = (6, NZ, N, N)
    area = 1.0 + 0.1 * rng.rand(6, N, N)
    fields = [100.0 + np.abs(rng.randn(*sh)), 100.0 + np.abs(rng.randn(*sh)),
              300.0 + 10.0 * rng.randn(*sh), 300.0 + 10.0 * rng.randn(*sh),
              rng.randn(*sh), rng.randn(*sh),
              -100.0 + 5.0 * rng.randn(*sh), -100.0 + 5.0 * rng.randn(*sh),
              1e-4 * rng.randn(*sh), 1e-4 * rng.randn(*sh),
              0.2 * rng.randn(*sh), 0.2 * rng.randn(*sh)]
    fields += [0.05 * area[:, None] * rng.randn(*sh) for _ in range(4)]
    args = [_t(a, dev) for a in fields + [area, area + 0.01]]
    got = advection.fv_tp_2d_multi5(*args, hord)
    want = advection.fv_tp_2d_multi5_plain(*args, hord)
    sl = np.s_[:, :, 2 : N - 2, 2 : N - 2]
    for g, w in zip(got, want):  # K1's tolerance
        torch.testing.assert_close(g[sl], w[sl], rtol=1e-4, atol=1e-3)
    # against five K1 calls in the unfused wiring
    five = advection.transports5(fv_tp_2d_cuda, *args, hord)
    for g, f in zip(got, five):
        assert float((g - f).abs().max()) <= 1e-6 * float(f.abs().max())
    assert fv_tp_2d_multi5_cuda.launches > 0


def test_probe_kernels(dev):
    x = _t(np.random.RandomState(0).randn(*probe.SHAPE), dev)
    assert torch.equal(probe.affine(x), probe.affine_plain(x))
    assert torch.equal(probe.stencil(x), probe.stencil_plain(x))


def _multi5_args(rng, N, nz, dev):
    sh = (6, nz, N, N)
    area = 1.0 + 0.1 * rng.rand(6, N, N)
    fields = [100.0 + np.abs(rng.randn(*sh)), 100.0 + np.abs(rng.randn(*sh)),
              300.0 + 10.0 * rng.randn(*sh), 300.0 + 10.0 * rng.randn(*sh),
              rng.randn(*sh), rng.randn(*sh),
              -100.0 + 5.0 * rng.randn(*sh), -100.0 + 5.0 * rng.randn(*sh),
              1e-4 * rng.randn(*sh), 1e-4 * rng.randn(*sh),
              0.2 * rng.randn(*sh), 0.2 * rng.randn(*sh)]
    fields += [0.05 * area[:, None] * rng.randn(*sh) for _ in range(4)]
    return [_t(a, dev) for a in fields + [area, area + 0.01]]


@pytest.mark.parametrize("N", [11, 40, 80, 198])
@pytest.mark.parametrize("hord", [5, 8])
def test_multi5_kernel_tiles(dev, N, hord):
    """K6's tiles (csrc/tp2d_multi5.cu, 18 x 33): a lattice smaller than
    one tile (11), ragged last tiles (40, 80), interior tiles that load
    without wrapping (80, 198) and the C192 width, which the tiles fit
    exactly (198); every face of the padded lattice against
    five K1 calls (the gate of chip_smoke.py, FUSED_RTOL) and the consumed
    faces against the plain form (K1's tolerance)."""
    args = _multi5_args(np.random.RandomState(N + hord), N, 3, dev)
    got = advection.fv_tp_2d_multi5(*args, hord)
    five = advection.transports5(fv_tp_2d_cuda, *args, hord)
    want = advection.fv_tp_2d_multi5_plain(*args, hord)
    sl = np.s_[:, :, 2 : N - 2, 2 : N - 2]
    for g, f, w in zip(got, five, want):
        assert bool(torch.isfinite(g).all())
        assert float((g - f).abs().max()) <= 1e-6 * float(f.abs().max())
        torch.testing.assert_close(g[sl], w[sl], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("case", ["coincident", "beyond"])
@pytest.mark.parametrize("iv,kord", [(1, 9), (0, 10), (-1, 17)])
def test_remap_kernel_merge_walk_cases(dev, case, iv, kord):
    """K5's merge walk where target edges lie exactly on source edges and
    where they reach above and below the source column; a tracer stack
    (F = 2 Fp) over several blocks of columns."""
    rng = np.random.RandomState(kord - iv)
    ny, nx = n, n + 1

    def edges():
        w = np.cumsum(0.2 + rng.rand(6, NZ + 1, ny, nx), axis=1)
        return 300.0 + (w - w[:, :1]) / (w[:, -1:] - w[:, :1]) * 9.97e4

    pe1 = edges().astype(np.float32)
    pe2 = edges().astype(np.float32)
    if case == "coincident":
        pe2[:, 10], pe2[:, 30], pe2[:, 31] = pe1[:, 9], pe1[:, 30], pe1[:, 32]
        pe2 = np.sort(pe2, axis=1)
    else:
        pe2 = (pe2.astype(np.float64) * 1.04 - 2500.0).astype(np.float32)
    q = 1.0 + rng.randn(12, NZ, ny, nx)
    q, pe1, pe2 = (_t(a, dev) for a in (q, pe1, pe2))
    got = remap.remap_levels(q, pe1, pe2, iv, kord)
    want = remap.remap_levels_plain(q, pe1, pe2, iv, kord)
    assert bool(torch.isfinite(got).all())
    # the JAX kernel test's tolerance (test_pallas_kernels.py:228)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
