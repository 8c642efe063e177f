"""fv3net_tpu_torch's CUDA kernels against their plain torch versions on
the card (float32, C12 widths).  Skipped where there is no GPU; on the
GPU machine (no JAX there, so without tests/conftest.py) run
`python -m pytest tests/test_torch_cuda.py -q --noconftest`."""

import numpy as np
import pytest
import torch

from fv3net_tpu_torch.dycore import riemann, sw
from fv3net_tpu_torch.grid import halo_exchange
from fv3net_tpu_torch.ops import advection, cuda_column
from fv3net_tpu_torch.ops.cuda_sim1 import sim1_solver_cuda
from fv3net_tpu_torch.ops.cuda_tp import fv_tp_2d_cuda

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
