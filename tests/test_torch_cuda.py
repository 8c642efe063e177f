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
from fv3net_tpu_torch.util.quantity import Quantity
from torch_parity import assert_close_scaled

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


@pytest.mark.parametrize("mass_weighted", [False, True])
@pytest.mark.parametrize("N", [11, 18, 54, 198])
def test_fv_tp_2d_kernel_whole_lattice(dev, N, mass_weighted):
    """K1's tiles (csrc/tp2d.cu, 18 x 33, 8-byte copies for even N): a
    lattice smaller than one tile with 4-byte copies (11) and with pairs
    (18), ragged tiles (54, the C48 width) and the C192 width, where each
    block runs its ring over several levels (198); every face of the
    padded lattice against the plain version, one launch a call."""
    rng = np.random.RandomState(N)
    sh = (6, NZ, N, N)
    area = 1.0 + 0.1 * rng.rand(6, 1, N, N)
    args = [rng.randn(*sh), rng.randn(*sh), 0.2 * rng.randn(*sh),
            0.2 * rng.randn(*sh), 0.05 * area * rng.randn(*sh),
            0.05 * area * rng.randn(*sh)]
    if mass_weighted:
        dp = 100.0 + rng.rand(*sh)
        args += [area * dp, (area + 0.01) * dp]
    else:
        args += [area, area + 0.01]
    args = [_t(a, dev) for a in args]
    for hord in (1, 5, 6, 8):
        launches = fv_tp_2d_cuda.launches
        got = advection.fv_tp_2d(*args, hord)
        assert fv_tp_2d_cuda.launches == launches + 1
        want = advection.fv_tp_2d_plain(*args, hord)
        for g, w in zip(got, want):  # the JAX kernel test's tolerance
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-3)


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


@pytest.mark.parametrize("width", [12, 48])
def test_sim1_kernel_padded(dev, width):
    """K2 reading pem, pm and ws through their halo, as the step passes
    them (NaN and garbage in the halo): one launch, within the JAX kernel
    test's tolerance of the plain version on the interior, and bit for bit
    the launch on contiguous interior copies (C12 and C48 widths: a ragged
    last tile and tiles over two faces)."""
    rng = np.random.RandomState(width)
    nw = width
    pe = np.sort(np.linspace(300.0, 1e5, NZ + 1)[:, None, None]
                 * (1.0 + 0.01 * rng.rand(6, NZ + 1, nw, nw)), axis=1)
    delp = pe[:, 1:] - pe[:, :-1]
    pt = np.clip(300.0 + 30.0 * rng.randn(6, NZ, nw, nw), 200.0, 400.0)
    tt = torch.as_tensor
    pm = riemann.layer_mean_pressure(tt(delp), tt(pe)).numpy()
    dz = riemann.hydrostatic_dz(tt(delp), tt(pt), tt(pe)).numpy()
    inner = [_t(a, dev) for a in (delp / 9.80665, pt, dz,
                                  2.0 * rng.randn(6, NZ, nw, nw), pe, pm,
                                  0.5 * rng.randn(6, nw, nw))]

    def pad(a):
        out = 1e30 * torch.randn(*a.shape[:-2], nw + 2 * H, nw + 2 * H,
                                 device=dev)
        out[..., 0, :] = float("nan")
        out[..., H : H + nw, H : H + nw] = a
        return out

    padded = inner[:4] + [pad(a) for a in inner[4:]]
    launches = sim1_solver_cuda.launches
    got = riemann.sim1_solve(150.0, *padded, halo=H)
    assert sim1_solver_cuda.launches == launches + 1
    for g, c in zip(got, sim1_solver_cuda(150.0, *inner)):
        assert torch.equal(g, c)
    want = riemann.sim1_solver(150.0, *inner)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4,
                               atol=float(want[2].abs().max()) * 1e-4)


@pytest.mark.parametrize("width", [18, 54, 198])
def test_column_kernel_ragged_padded(dev, width):
    """K4 on padded faces of the C12, C48 and C192 widths (6 N^2 columns
    end in a ragged tile at each) with garbage and NaN halo-corner
    columns: one launch, the JAX kernel test's tolerances elsewhere, NaN
    where the plain version has NaN."""
    rng = np.random.RandomState(width)
    dp = _t(900.0 + 200.0 * rng.rand(6, NZ, width, width), dev)
    dp[:, :, 0, 0] = -1e6
    dp[:, :, 0, -1] = float("nan")
    launches = cuda_column.column_pressures_cuda.launches
    got = cuda_column.column_pressures(dp, 300.0)
    assert cuda_column.column_pressures_cuda.launches == launches + 1
    want = cuda_column.column_pressures_plain(dp, 300.0)
    for g, w, rtol in zip(got, want, (1e-6, 1e-5, 1e-5)):
        torch.testing.assert_close(g, w, rtol=rtol, atol=0.0,
                                   equal_nan=True)


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


@pytest.mark.parametrize("nz", [NZ, 0])
@pytest.mark.parametrize("width", [12, 48, 192])
def test_filter_kernel_widths(dev, width, nz):
    """K3 at the widths of C12, C48 and C192 (ragged tiles at 12, tiles
    whose regions are interior at 192), 4-D and 3-D q: one launch a call,
    within the JAX kernel test's tolerance of the plain version."""
    from fv3net_tpu_torch.ops.cuda_filter import del4_filter_cuda

    rng = np.random.RandomState(width)
    area = _t(1.0 + 0.1 * rng.rand(6, width, width), dev)
    m = type("M", (), dict(
        n=width, halo=H, area_px=halo_exchange(area, H, fill="x"),
        area_py=halo_exchange(area, H, fill="y"), rarea=1.0 / area,
    ))
    shape = (6, nz, width, width) if nz else (6, width, width)
    q = _t(rng.randn(*shape), dev)
    launches = del4_filter_cuda.launches
    got = sw.scalar_filter(q, m, sw.FILTER_COEF)
    assert del4_filter_cuda.launches == launches + 1
    assert got.shape == q.shape
    torch.testing.assert_close(got, sw.scalar_filter_plain(q, m,
                                                           sw.FILTER_COEF),
                               rtol=1e-4, atol=1e-5)


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


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (3, 7),
                                   (16, 1024), (4099, 4097)])
def test_probe_kernels_odd_shapes_and_offsets(dev, shape, offset):
    """K7 and K8 bit for bit on shapes whose columns are not a multiple
    of 4 and on views starting 0-3 floats past a 16-byte boundary (the
    allocator's blocks start on one), one launch each."""
    rows, cols = shape
    buf = _t(np.random.RandomState(rows + offset).randn(rows * cols
                                                        + offset), dev)
    x = buf[offset:].view(rows, cols)
    assert x.data_ptr() % 16 == 4 * offset
    before = probe.affine_cuda.launches, probe.stencil_cuda.launches
    assert torch.equal(probe.affine(x), probe.affine_plain(x))
    assert torch.equal(probe.stencil(x), probe.stencil_plain(x))
    assert (probe.affine_cuda.launches - before[0],
            probe.stencil_cuda.launches - before[1]) == (1, 1)


def test_probe_wrappers_refuse_and_skip_empty(dev):
    x = _t(np.ones((4, 8)), dev)
    for fn in (probe.affine_cuda, probe.stencil_cuda):
        with pytest.raises(ValueError, match="contiguous"):
            fn(x.t())
        with pytest.raises(TypeError, match="float32"):
            fn(x.double())
        with pytest.raises(ValueError, match="2-D"):
            fn(x[0])
        before = fn.launches
        assert fn(x[:0]).shape == (0, 8) and fn.launches == before


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


# --- the eager runtime on CUDA state ----------------------------------------
# Traps the CPU tests cannot show: np.asarray of a CUDA tensor raises, and a
# host array meets a CUDA tensor in the tendency arithmetic.


def _moist_state(wrapper, seed):
    """Seeded temperature noise, a warm boundary layer in a seeded share
    of the columns and humidity at a seeded relative humidity up to 5%
    supersaturated below and 30% of it aloft: moist enough that the GFS
    suite's shallow-convection trigger fires in some columns (on the CPU
    in float64 at C12 x 63: 102 of 864 columns after one step)."""
    from fv3net_tpu_torch.physics import gfs

    rng = np.random.RandomState(seed)
    mdl = wrapper.get_model()
    nz, nn = mdl.nz, mdl.n
    st = wrapper.get_state(["air_temperature",
                            "pressure_thickness_of_atmospheric_layer"])
    t = st["air_temperature"].values + rng.randn(6, nz, nn, nn)
    k = np.arange(nz)[None, :, None, None]
    t = t + 10.0 * rng.uniform(0, 1, size=(6, 1, nn, nn)) * np.exp(
        -(nz - 1 - k) / 4.0)
    delp = st["pressure_thickness_of_atmospheric_layer"].values
    p = np.cumsum(delp, axis=1) + mdl.config.ptop - 0.5 * delp
    qs = gfs.qsat(torch.as_tensor(t), torch.as_tensor(p)).numpy()
    rh = rng.uniform(0.5, 1.05, size=(6, 1, nn, nn)) * np.where(
        k > nz - 12, 1.0, 0.3)
    q = np.minimum(rh * qs, 0.02)
    temp = st["air_temperature"]
    wrapper.set_state({"specific_humidity": temp.with_data(q),
                       "air_temperature": temp.with_data(t)})


def _init_cuda(dev, **kw):
    from fv3net_tpu_torch import wrapper

    wrapper.initialize(wrapper.ModelConfig(npx=n + 1, npz=NZ, **kw),
                       device=dev)
    return wrapper


class _ConstantTendency:
    """Predictions as host arrays (numpy), as a simple model gives them."""

    input_variables = ["air_temperature", "specific_humidity"]

    def predict(self, state):
        t = state["air_temperature"]
        return {"dQ1": t.with_data(np.full(t.shape, 1e-5, np.float32)),
                "dQ2": t.with_data(np.full(t.shape, -1e-8, np.float32))}


@pytest.mark.parametrize("model", ["dense", "constant"])
def test_time_loop_steppers_on_cuda_state(dev, tmp_path, model):
    """Two TimeLoop steps on CUDA state with an SST prescriber
    (prephysics), and an ML stepper (the port's dense model on the
    device, or host-array predictions) combined with a nudger of x_wind
    (host arrays) as postphysics: diagnostics stay on the card, the state
    stays finite, the prescriber and the nudger take effect, and
    postphysics conserves dry mass."""
    from fv3net_tpu_torch import fit
    from fv3net_tpu_torch.runtime import coupled_bench, derived_state, loop
    from fv3net_tpu_torch.runtime import steppers

    wrapper = _init_cuda(dev)
    mdl = wrapper.get_model()
    _moist_state(wrapper, seed=3)
    state = derived_state.MergedState(derived_state.DerivedModelState(wrapper))
    mask = (np.arange(6 * n * n).reshape(6, n, n) % 2).astype(float)
    state.overlay["land_sea_mask"] = Quantity(mask, ("tile", "y", "x"))
    sst = Quantity(np.full((6, n, n), 295.0), ("tile", "y", "x"))
    target = state["x_wind"].values + 3.0
    if model == "dense":
        ml = fit.load(coupled_bench.train_dense_artifact(
            str(tmp_path / "dense"), NZ, dev))
    else:
        ml = _ConstantTendency()
    post = steppers.CombinedStepper([
        steppers.PureMLStepper(ml, dt=mdl.config.dt_atmos),
        steppers.PureNudger(
            steppers.NudgingConfig(timescale_hours={"x_wind": 1.0}),
            lambda time: {"x_wind": Quantity(
                target, ("tile", "z", "y_interface", "x"))},
        ),
    ])
    pre = [steppers.Prescriber(
        steppers.PrescriberConfig(variables=["surface_temperature"]),
        lambda time: {"surface_temperature": sst},
    )]
    tl = loop.TimeLoop(wrapper, state, dt=mdl.config.dt_atmos,
                       prephysics_steppers=pre, postphysics_stepper=post,
                       n_steps=2)
    for _, diags in tl:
        for key in ("water_vapor_path",
                    "tendency_of_air_temperature_due_to_python",
                    "storage_of_mass_due_to_python", "dQ1_filled_frac"):
            assert diags[key].data.is_cuda, key
        assert float(diags["dQ1_filled_frac"].data) == 0.0
    for k, x in mdl.state._asdict().items():
        if x is not None:
            assert x.is_cuda and bool(torch.isfinite(x).all()), k
    np.testing.assert_array_equal(mdl.tsfc, np.where(mask == 0, 295.0, 288.0))
    tend = diags["tendency_of_air_temperature_due_to_python"].values
    assert np.isfinite(tend).all() and np.abs(tend).max() > 0.0
    assert "x_wind_tendency_due_to_nudging" in diags
    # the dry-mass-conserving humidity set (postphysics) holds the dry
    # mass to float32 roundoff
    dry = diags["storage_of_mass_due_to_python"].values
    assert np.isfinite(dry).all()


def test_wrapper_host_transforms_on_cuda_state(dev):
    """set_state_mass_conserving with a CUDA and a host humidity,
    transform_agrid_winds_to_dgrid_winds from CUDA quantities, and
    get_state(surface_geopotential) of a CUDA phis: no host conversion
    of a CUDA tensor raises, and each result equals the one from host
    inputs."""
    wrapper = _init_cuda(dev)
    mdl = wrapper.get_model()
    st = wrapper.get_state(["specific_humidity",
                            "pressure_thickness_of_atmospheric_layer"])
    q0 = st["specific_humidity"]
    dp0 = st["pressure_thickness_of_atmospheric_layer"].values
    q_new = np.full(q0.shape, 2e-3, np.float32)
    out = []
    for data in (torch.as_tensor(q_new, device=dev), q_new):
        wrapper.set_state({"pressure_thickness_of_atmospheric_layer":
                           Quantity(dp0, q0.dims), "specific_humidity":
                           q0.with_data(np.zeros(q0.shape, np.float32))})
        wrapper.set_state_mass_conserving(
            {"specific_humidity": q0.with_data(data)})
        assert mdl.state.delp.is_cuda and mdl.state.q.is_cuda
        out.append(mdl.state.delp.cpu())
        dry = float((mdl.state.delp.double() * (1 - mdl.state.q[0].double())
                     ).sum())
        assert dry == pytest.approx(float(dp0.astype(np.float64).sum()),
                                    rel=1e-6)
    assert torch.equal(out[0], out[1])
    rng = np.random.RandomState(1)
    ua, va = (rng.randn(6, NZ, n, n) for _ in range(2))
    dims = ("tile", "z", "y", "x")
    got = wrapper.transform_agrid_winds_to_dgrid_winds(
        Quantity(torch.as_tensor(ua, device=dev), dims),
        Quantity(torch.as_tensor(va, device=dev), dims))
    want = wrapper.transform_agrid_winds_to_dgrid_winds(
        Quantity(ua, dims), Quantity(va, dims))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.values, w.values)
    wrapper.set_state({"x_wind": got[0], "y_wind": got[1]})
    assert mdl.state.u.is_cuda
    east = wrapper.get_state(["eastward_wind"])["eastward_wind"]
    assert np.isfinite(east.values).all()
    phis = torch.as_tensor(rng.rand(6, n, n) * 1e3, dtype=torch.float32,
                           device=dev)
    wrapper.set_state({"surface_geopotential": Quantity(
        phis, ("tile", "y", "x"))})
    geo = wrapper.get_state(["surface_geopotential"])["surface_geopotential"]
    assert isinstance(geo.data, np.ndarray)
    np.testing.assert_array_equal(geo.data, phis.cpu().numpy())


def _gfs_step(device, dtype):
    """One eager step (dynamics, radiation, GFS physics) from the seeded
    moist state: the state, total precipitation and the shallow-
    convection and PBL diagnostics, on the CPU in float64."""
    from fv3net_tpu_torch import wrapper

    wrapper.initialize(wrapper.ModelConfig(
        npx=n + 1, npz=NZ, physics_suite="gfs", dtype=dtype), device=device)
    _moist_state(wrapper, seed=10)
    for phase in (wrapper.step_dynamics, wrapper.step_pre_radiation,
                  wrapper.step_radiation, wrapper.step_post_radiation_physics,
                  wrapper.apply_physics):
        phase()
    mdl = wrapper.get_model()
    out = {k: x.double().cpu() for k, x in mdl.state._asdict().items()
           if x is not None}
    out["total_precip"] = mdl.total_precip.double().cpu()
    diags = {k: torch.as_tensor(wrapper.get_diagnostic_by_name(k).values)
             .double() for k in ("shallow_convection_active",
                                 "planetary_boundary_layer_height",
                                 "convective_precipitation")}
    return out, diags


def test_eager_gfs_step_on_card_fires_shallow_convection(dev):
    """One eager GFS step on the card in float32 against the CPU in
    float32 and float64 from the same seeded moist state, in which
    shallow convection fires: the card's f32 state is as close to the f64
    state as the CPU's f32 is (factor 3, chip_smoke.py's F32_FACTOR rule)
    outside the columns in which a physics threshold decided differently
    on the card and on the CPU in f32 (at most 1%)."""
    got, gd = _gfs_step(dev, "float32")
    plain, pd = _gfs_step("cpu", "float32")
    ref, _ = _gfs_step("cpu", "float64")
    active = int(gd["shallow_convection_active"].sum())
    ncol = gd["shallow_convection_active"].numel()
    print(f"shallow convection active in {active} of {ncol} columns on the "
          f"card ({int(pd['shallow_convection_active'].sum())} on the CPU)")
    assert active > 0
    flips = (
        (gd["shallow_convection_active"] != pd["shallow_convection_active"])
        | ((gd["convective_precipitation"] > 0)
           != (pd["convective_precipitation"] > 0))
        | ((gd["planetary_boundary_layer_height"]
            - pd["planetary_boundary_layer_height"]).abs() > 1.0)
    )
    assert int(flips.sum()) <= 0.01 * ncol
    for k, r in ref.items():
        keep = ~flips
        if r.ndim == 4:
            keep = keep[:, None]
        if r.ndim == 5:
            keep = keep[None, :, None]
        if r.shape[-2] == n + 1:
            keep = torch.nn.functional.pad(keep, (0, 0, 0, 1)) & \
                torch.nn.functional.pad(keep, (0, 0, 1, 0))
        if r.shape[-1] == n + 1:
            keep = torch.nn.functional.pad(keep, (0, 1)) & \
                torch.nn.functional.pad(keep, (1, 0))
        keep = keep.expand(r.shape)
        a, p, w = (torch.where(keep, x[k], 0.0) for x in (got, plain, ref))
        assert bool(torch.isfinite(got[k]).all()), k
        e_card = float((a - w).abs().max())
        e_plain = float((p - w).abs().max())
        assert e_card <= 3.0 * e_plain + 1e-7 * float(w.abs().max()), (
            k, e_card, e_plain)


# --- the nudged run (restarts, GFDL microphysics, mass-flux convection) ----


def _restart_dir(path, n_, nz, seed=0):
    """INPUT/ written by the port's write_restarts from a seeded state
    with two species and no w or delz (numpy float64)."""
    import datetime

    from fv3net_tpu_torch.dycore.hydro import DycoreState
    from fv3net_tpu_torch.io import restarts

    rng = np.random.RandomState(seed)
    ak = np.linspace(300.0, 0.0, nz + 1)
    bk = np.linspace(0.0, 1.0, nz + 1)
    pe = ak[:, None, None] + bk[:, None, None] * 1e5
    delp = np.broadcast_to(pe[1:] - pe[:-1], (6, nz, n_, n_)).copy()
    state = DycoreState(
        delp, 300.0 + rng.randn(6, nz, n_, n_),
        rng.randn(6, nz, n_ + 1, n_), rng.randn(6, nz, n_, n_ + 1),
        1e-3 * rng.rand(2, 6, nz, n_, n_))
    restarts.write_restarts(
        restarts.restarts_from_state(state, np.zeros((6, n_, n_)), 300.0),
        str(path), time=datetime.datetime(2016, 8, 1, 6), subdir="INPUT")
    return str(path)


def test_initialize_from_restart_lands_on_the_card(dev, tmp_path):
    """With no device, initialize from restart files puts the state on
    the card, equal to the CPU's ingest of the same files bit for bit."""
    from fv3net_tpu_torch import wrapper

    cfg = wrapper.ModelConfig(
        npx=n + 1, npz=8, hydrostatic=False, physics_suite="gfs",
        microphysics_scheme="gfdl", prognostic_mp_tracers=True,
        restart_dir=_restart_dir(tmp_path, n, 8))
    wrapper.initialize(cfg, device="cpu")
    want = {k: x.clone() for k, x in wrapper.get_model().state._asdict()
            .items()}
    wrapper.initialize(cfg)
    mdl = wrapper.get_model()
    assert mdl.device.type == "cuda" and mdl.phis.is_cuda
    assert mdl.state.q.shape[0] == 6 and mdl.time.hour == 6
    for k, w in want.items():
        g = getattr(mdl.state, k)
        assert g.is_cuda, k
        if k == "delz":  # integrated on each device from the same state
            torch.testing.assert_close(g.cpu(), w, rtol=1e-6, atol=0.0)
        else:
            assert torch.equal(g.cpu(), w), k


def _gfdl_rain_step(device, dtype):
    """apply_physics of the GFDL suite with six species at C12 x 63 from
    a dry state with a rain layer aloft, every other process off: the
    rain falls (and partly evaporates) through the column within the
    step.  The rain field and the rain reaching the surface, float64 on
    the CPU."""
    import dataclasses

    from fv3net_tpu_torch import wrapper

    wrapper.initialize(wrapper.ModelConfig(
        npx=n + 1, npz=NZ, physics_suite="gfs", microphysics_scheme="gfdl",
        prognostic_mp_tracers=True, do_radiation=False, hydrostatic=False,
        dtype=dtype), device=device)
    mdl = wrapper.get_model()
    q = torch.zeros_like(mdl.state.q)
    q[3, :, 20] = 2e-3  # rain at level 20 of 63
    mdl.state = mdl.state._replace(q=q)
    mdl.gfs_config = dataclasses.replace(
        mdl.gfs_config, do_convection=False, do_shallow_convection=False,
        do_pbl=False, do_surface=False)
    wrapper.apply_physics()
    rain = wrapper.get_diagnostic_by_name("rain_precipitation").values
    return mdl.state.q[3].double().cpu(), torch.as_tensor(rain).double()


def test_eager_gfdl_step_on_card_sediments_rain(dev):
    """The card's GFDL step moves the seeded rain down and out of the
    column as the CPU's does: at 63 levels every layer is thinner than
    the rain's fall in a step (6 m/s x 900 s), so the rain reaches the
    surface within the step, less what evaporates on the way.  Rain at
    the surface in every column, within 1e-4 of the float64 CPU step
    (the f32 roundoff of ~40 level updates), and no rain left aloft
    beyond 1e-4 of the seeded amount."""
    q_card, rain_card = _gfdl_rain_step(dev, "float32")
    q_ref, rain_ref = _gfdl_rain_step("cpu", "float64")
    print(f"rain at the surface on the card: {float(rain_card.min()):.4f}"
          f"-{float(rain_card.max()):.4f} kg/m2, left aloft "
          f"{float(q_card.abs().max()):.3e} (CPU float64: "
          f"{float(rain_ref.min()):.4f}-{float(rain_ref.max()):.4f}, "
          f"{float(q_ref.abs().max()):.3e})")
    assert float(rain_card.min()) > 0.0
    torch.testing.assert_close(rain_card, rain_ref, rtol=1e-4, atol=0.0)
    assert float((q_card - q_ref).abs().max()) <= 1e-4 * 2e-3


def test_sas_mass_flux_fires_on_card_as_on_cpu(dev):
    """A seeded set of columns, half of them unstable: the SAS trigger
    fires in the same columns on the card as on the CPU (f32), and the
    card's f32 result is as close to the CPU's float64 one as the CPU's
    f32 is (factor 3)."""
    from fv3net_tpu_torch.physics.convection import sas_mass_flux

    nz, n_ = 20, 8
    rng = np.random.RandomState(2)
    pe = np.linspace(100e2, 1000e2, nz + 1)
    p = 0.5 * (pe[1:] + pe[:-1])
    t_dry = 300.0 * (p / 1000e2) ** 0.286
    unstable = rng.rand(6, 1, n_, n_) < 0.5

    def tile(a):
        return np.broadcast_to(a[None, :, None, None],
                               (6, a.shape[0], n_, n_)).copy()

    t = np.where(unstable, tile(t_dry - 6.0 * (1 - p / 1000e2)),
                 tile(t_dry + 30.0 * (1 - p / 1000e2)))
    t = t + 0.5 * rng.randn(6, nz, n_, n_)
    qv = np.where(unstable, tile(np.where(p > 800e2, 0.018, 0.002)),
                  1e-3) * rng.uniform(0.6, 1.1, size=(6, 1, n_, n_))
    args = (t, qv, tile(p), tile(pe), tile(np.diff(pe)))
    ref, plain, got = (
        [x.double().cpu() for x in sas_mass_flux(
            *(torch.as_tensor(a, dtype=dtype, device=device)
              for a in args), 900.0)]
        for device, dtype in (("cpu", torch.float64), ("cpu", torch.float32),
                              (dev, torch.float32)))
    fired = got[2] > 0
    print(f"SAS fires in {int(fired.sum())} of {fired.numel()} columns on "
          f"the card ({int((plain[2] > 0).sum())} on the CPU)")
    assert 0 < int(fired.sum()) < fired.numel()
    assert torch.equal(fired, plain[2] > 0)
    assert torch.equal(fired, ref[2] > 0)
    for g, p_, r in zip(got, plain, ref):
        e_card = float((g - r).abs().max())
        e_plain = float((p_ - r).abs().max())
        assert e_card <= 3.0 * e_plain + 1e-7 * float(r.abs().max())


def test_fit_load_defaults_to_the_card(dev, tmp_path):
    """fit.load without a device puts the model's parameters on the card,
    and a numpy state's prediction (run there, returned as numpy) is as
    close to the float64 prediction as the CPU's float32 one is
    (parity.f32_rule)."""
    import copy

    from fv3net_tpu_torch import fit, parity
    from fv3net_tpu_torch.runtime import coupled_bench

    path = coupled_bench.train_dense_artifact(str(tmp_path / "dense"), NZ,
                                              "cpu")
    card, cpu = fit.load(path), fit.load(path, "cpu")
    assert {p.device.type for p in card.module.parameters()} == {"cuda"}
    rng = np.random.RandomState(11)
    dims = ("tile", "z", "y", "x")
    X = {"air_temperature": Quantity(
             260.0 + 10.0 * rng.randn(6, NZ, n, n), dims),
         "specific_humidity": Quantity(
             5e-3 + 1e-3 * rng.randn(6, NZ, n, n), dims)}
    got, want32 = card.predict(X), cpu.predict(X)
    x = cpu.scaler_in.normalize(cpu.packer_in.to_array(X))
    with torch.no_grad():
        yn = copy.deepcopy(cpu.module).double()(
            torch.as_tensor(x, dtype=torch.float64)).numpy()
    ref64 = cpu.packer_out.to_state(cpu.scaler_out.denormalize(yn),
                                    cpu._templates(X))
    for k in ("dQ1", "dQ2"):
        assert isinstance(got[k].data, np.ndarray)
    as_t = lambda s: {k: torch.as_tensor(np.asarray(q.data))  # noqa: E731
                      for k, q in s.items()}
    for k, (err, bound, scale, errs, finite) in parity.f32_rule(
            as_t(got), [as_t(want32)], as_t(ref64)).items():
        assert finite and err <= bound, (k, err, bound, errs)


@pytest.mark.parametrize("family", ["dense", "convolutional"])
def test_training_step_on_card_matches_cpu(dev, family):
    """One Adam step of a family on the card and on the CPU from the same
    seeded init and batch: the parameters agree to 1e-5 of each array's
    magnitude (float32 on both; the convolutions in IEEE float32 on the
    card, not TF32)."""
    from fv3net_tpu_torch import fit
    from fv3net_tpu_torch.convert import module_flax_params

    rng = np.random.RandomState(12)
    dims = ("tile", "z", "y", "x")
    a = rng.randn(6, 8, n, n).astype(np.float32)
    batch = {"a": Quantity(a, dims),
             "b": Quantity(2.0 * a + 0.1 * rng.randn(*a.shape).astype(
                 np.float32), dims)}
    if family == "dense":
        def train(device):
            return fit.train_dense_model(
                fit.DenseHyperparameters(epochs=1, batch_size=6 * n * n),
                [batch], input_variables=["a"], output_variables=["b"],
                device=device)
    else:
        def train(device):
            return fit.train_convolutional_model(
                fit.ConvolutionalHyperparameters(epochs=1), [batch],
                input_variables=["a"], output_variables=["b"],
                device=device)
    got = module_flax_params(train(dev).module)
    want = module_flax_params(train("cpu").module)
    for layer, p in want.items():
        for k, w in p.items():
            scale = np.abs(p["kernel"]).max()
            err = np.abs(got[layer][k] - w).max()
            assert err <= 1e-5 * scale, (layer, k, err, scale)


@pytest.mark.parametrize("family", ["dense", "convolutional"])
def test_captured_training_loop_equals_eager(dev, family, monkeypatch):
    """A family's training loop on the card replays its captured step
    (fit._shared.training_step: one graph a batch shape, after
    graphs.WARMUP eager steps of it) and ends with the eager loop's parameters bit for bit,
    with the capturable Adam on both sides (the convolutions in IEEE
    float32 by cuDNN's deterministic algorithms on both, as the family
    trains)."""
    from fv3net_tpu_torch import fit, graphs
    from fv3net_tpu_torch.convert import module_flax_params

    made = []

    class Counted(graphs._Capture):
        def __init__(self, *args, **kwargs):
            made.append(1)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(graphs, "_Capture", Counted)
    rng = np.random.RandomState(14)
    dims = ("tile", "z", "y", "x")
    batches = []
    for _ in range(2):
        a = rng.randn(6, 8, n, n).astype(np.float32)
        batches.append({"a": Quantity(a, dims), "b": Quantity(
            2.0 * a + 0.1 * rng.randn(*a.shape).astype(np.float32), dims)})
    if family == "dense":
        # 1728 samples in batches of 500: three full and a short one an
        # epoch, two graphs
        def train():
            return fit.train_dense_model(
                fit.DenseHyperparameters(epochs=3, batch_size=500), batches,
                input_variables=["a"], output_variables=["b"], device=dev)
        captures = 2
    else:  # one cube a step, 8 steps
        def train():
            return fit.train_convolutional_model(
                fit.ConvolutionalHyperparameters(epochs=4), batches,
                input_variables=["a"], output_variables=["b"], device=dev)
        captures = 1
    with graphs.eager():
        want = module_flax_params(train().module)
    assert not made
    got = module_flax_params(train().module)
    assert len(made) == captures
    for layer, p in want.items():
        for k, w in p.items():
            np.testing.assert_array_equal(got[layer][k], w, f"{layer} {k}")


def _series_batches(T, nz=2):
    """A seeded time series of [6, nz, n, n] states, each step a
    smooth function of the last, with a [6, n, n] forcing."""
    rng = np.random.RandomState(13)
    dims3, dims2 = ("tile", "z", "y", "x"), ("tile", "y", "x")
    s = rng.randn(6, nz, n, n).astype(np.float32)
    out = []
    for t in range(T):
        f = np.cos(0.3 * t + rng.rand(6, n, n)).astype(np.float32)
        out.append({"s": Quantity(s.copy(), dims3),
                    "g": Quantity((0.5 * s).copy(), dims3),
                    "f": Quantity(f, dims2)})
        s = (0.9 * s + 0.1 * np.roll(s, 1, axis=-1) + 0.2 * f[:, None]
             ).astype(np.float32)
    return out


FAMILIES = ["reservoir", "fmr", "mpg", "unet", "autoencoder", "cyclegan"]


def _train_family(family, device):
    """(trained model, its prediction on a held input) of a family at C12,
    its training function called without a device where `device` is
    None."""
    from fv3net_tpu_torch import fit

    kw = {} if device is None else {"device": device}
    series = _series_batches(24)
    if family == "reservoir":
        model = fit.train_reservoir_model(
            fit.ReservoirHyperparameters(state_size=64, burn_in=4),
            series[:-1], input_variables=["s"], output_variables=["s"], **kw)
        model.synchronize(series[:-2])
        return model, model.predict(series[-2])
    if family == "fmr":
        model = fit.train_fmr_model(
            fit.FMRHyperparameters(hidden=16, epochs=2), series,
            input_variables=["f"], output_variables=["s"], **kw)
    elif family in ("mpg", "unet"):
        model = fit.train_graph_model(
            fit.GraphHyperparameters(architecture=family, width=8, depth=2,
                                     epochs=1), series[:2],
            input_variables=["s"], output_variables=["g"], **kw)
    elif family == "autoencoder":
        model = fit.train_autoencoder(
            fit.AutoencoderHyperparameters(filters=4, epochs=2), series[:2],
            input_variables=["s"], **kw)
    else:
        model = fit.train_cyclegan(
            fit.CycleGANHyperparameters(filters=4, n_res=1, epochs=2),
            series[:2], input_variables=["s"], output_variables=["g"], **kw)
    return model, model.predict(series[-1])


@pytest.mark.parametrize("family", FAMILIES)
def test_family_trains_on_card_by_default(dev, family):
    """Each family's training function called without a device trains on
    the card (its parameters or matrices there), and its prediction is
    the CPU's within 1e-4 of the output's magnitude (float32 on both; a
    few steps, or the reservoir's float32 ridge solve)."""
    got_model, got = _train_family(family, None)
    tensors = (
        [got_model.W_out, got_model.reservoir.W_in]
        if family == "reservoir" else list(
            (got_model.gen_ab if family == "cyclegan"
             else got_model.module).parameters()))
    assert {t.device.type for t in tensors} == {"cuda"}
    _, want = _train_family(family, "cpu")
    for k, q in want.items():
        assert isinstance(got[k].data, np.ndarray)
        assert_close_scaled(got[k].values, q.values, 1e-4, f"{family} {k}")


def test_offline_evaluate_on_card_by_default(dev, tmp_path):
    """diagnostics.offline.evaluate without a device predicts on the card:
    its metrics are the CPU's within 1e-5 of each metric's magnitude."""
    import json

    from fv3net_tpu_torch import fit
    from fv3net_tpu_torch.diagnostics import offline
    from fv3net_tpu_torch.grid import CubedSphereGrid

    series = _series_batches(3)
    model = fit.train_dense_model(
        fit.DenseHyperparameters(epochs=2), series,
        input_variables=["s"], output_variables=["g"], device="cpu")
    fit.dump(model, str(tmp_path / "dense"))
    mapper = {f"2016080{i + 1}.000000": b for i, b in enumerate(series)}
    g = CubedSphereGrid.make(n, halo=3)
    grid = {"area": np.asarray(g.area[g.interior])}
    got = offline.evaluate(str(tmp_path / "dense"), mapper, grid,
                           str(tmp_path / "card"))
    want = offline.evaluate(str(tmp_path / "dense"), mapper, grid,
                            str(tmp_path / "cpu"), device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * abs(v), (k, got[k], v)
    with open(tmp_path / "card" / "scalar_metrics.json") as f:
        assert json.load(f) == got


@pytest.mark.parametrize("area_form", ["flat", "level"])
@pytest.mark.parametrize("hord", [1, 5, 6, 8])
def test_fv_tp_2d_kernel_single_layer(dev, hord, area_form):
    """K1's single-layer form: [F, N, N] fields (areas [F, N, N] or
    [F, 1, N, N]) give, in one launch, the [F, 1, N, N] form's fluxes bit
    for bit, and the plain version's within K1's tolerance."""
    rng = np.random.RandomState(30 + hord)
    sh = (6, N, N)
    area = 1.0 + 0.1 * rng.rand(*sh)
    args = [_t(a, dev) for a in (
        rng.randn(*sh), rng.randn(*sh), 0.2 * rng.randn(*sh),
        0.2 * rng.randn(*sh), 0.05 * area * rng.randn(*sh),
        0.05 * area * rng.randn(*sh))]
    areas = [_t(a, dev) for a in (area, area + 0.01)]
    if area_form == "level":
        areas = [a[:, None] for a in areas]
    launches = fv_tp_2d_cuda.launches
    got = advection.fv_tp_2d(*args, *areas, hord)
    assert fv_tp_2d_cuda.launches == launches + 1
    layered = fv_tp_2d_cuda(*(a[:, None] for a in args),
                            *(a.reshape(6, 1, N, N) for a in areas), hord)
    want = advection.fv_tp_2d_plain(
        *args, *(a.reshape(6, N, N) for a in areas), hord)
    sl = np.s_[:, 2 : N - 2, 2 : N - 2]
    for g, g4, w in zip(got, layered, want):
        assert g.shape == (6, N, N)
        assert torch.equal(g, g4[:, 0])
        torch.testing.assert_close(g[sl], w[sl], rtol=1e-4, atol=1e-3)


def test_pressure_coarsening_kernel(dev):
    """The pressure-level restart coarsening on the card: mappm's remap
    through K5 against the plain remap on the same tensors, with target
    edges above and below the source column (K5's tolerance); and the
    whole method (one K5 launch a 3D field) against the CPU's float32
    run within 1e-5 of each output's scale."""
    from fv3net_tpu_torch.utils import coarsen_restarts as cr

    rng = np.random.RandomState(40)
    w = np.cumsum(0.2 + rng.rand(6, NZ + 1, n, n), axis=1)
    pe1 = 300.0 + (w - w[:, :1]) / (w[:, -1:] - w[:, :1]) * 1e5
    pe2 = pe1 * (1.0 + 0.04 * (rng.rand(6, 1, n, n) - 0.5))
    pe2[:, 0] = 300.0 * (0.5 + rng.rand(6, n, n))
    q = _t(1.0 + 0.1 * rng.randn(6, NZ, n, n), dev)
    p1, p2 = _t(pe1, dev), _t(pe2, dev)
    assert bool((p2[:, -1] > p1[:, -1]).any() & (p2[:, -1] < p1[:, -1]).any())
    launches = ppm_remap_cuda.launches
    got = remap.remap_levels_mappm(q, p1, p2, 1, 9)
    assert ppm_remap_cuda.launches == launches + 1
    want = remap.ppm_remap_plain(q.movedim(1, 0), p1.movedim(1, 0),
                                 p2.movedim(1, 0), iv=1, kord=9
                                 ).movedim(0, 1)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)

    factor = 4
    h = np.repeat(np.repeat(400.0 * rng.rand(6, n // factor, n // factor),
                            factor, 1), factor, 2) * rng.uniform(-1, 1,
                                                                 (6, n, n))
    ps = 1.0e5 * np.exp(-h / 8400.0)
    delp = np.diff(300.0 + (ps[:, None] - 300.0) * np.linspace(0, 1, NZ + 1)[
        None, :, None, None], axis=1)
    state = {"pressure_thickness_of_atmospheric_layer": delp,
             "air_temperature": 250.0 + 30.0 * rng.rand(6, NZ, n, n),
             "specific_humidity": 1e-3 * rng.rand(6, NZ, n, n),
             "x_wind": rng.randn(6, NZ, n + 1, n),
             "y_wind": rng.randn(6, NZ, n, n + 1)}
    area = 1.0 + 0.1 * rng.rand(6, n, n)
    launches = ppm_remap_cuda.launches
    got = cr.coarsen_restarts_on_pressure(
        {k: _t(v, dev) for k, v in state.items()}, _t(area, dev), factor)
    assert ppm_remap_cuda.launches == launches + 2
    cpu = torch.device("cpu")
    want = cr.coarsen_restarts_on_pressure(
        {k: _t(v, cpu) for k, v in state.items()}, _t(area, cpu), factor)
    for k, v in want.items():
        assert_close_scaled(got[k].cpu().numpy(), v.numpy(), 1e-5, k)


def test_compute_diagnostics_on_card(dev):
    """compute_diagnostics with no device interpolates on the card: the
    diagnostics and metrics of the CPU run, the pressure-level groups
    within 1e-12 of each array's scale (float64 on both), every other
    group and every metric equal."""
    from fv3net_tpu_torch.diagnostics.compute import compute_diagnostics
    from fv3net_tpu_torch.grid import CubedSphereGrid

    rng = np.random.RandomState(50)
    nt, nz = 4, 8
    g = CubedSphereGrid.make(n, halo=3)
    grid = {"area": np.asarray(g.area[g.interior]),
            "lat": np.asarray(g.lat[g.interior]),
            "lon": np.asarray(g.lon[g.interior]),
            "delp": 1.0e5 / nz * (0.9 + 0.2 * rng.rand(nt, 6, nz, n, n))}
    run = {"surface_pressure": 1e5 + 100 * rng.randn(nt, 6, n, n),
           "air_temperature": 250 + 30 * rng.rand(nt, 6, nz, n, n)}
    ver = {k: v + rng.randn(*v.shape) for k, v in run.items()}
    got, got_m = compute_diagnostics(run, grid=grid, verification=ver)
    want, want_m = compute_diagnostics(run, grid=grid, verification=ver,
                                       device="cpu")
    assert sorted(got) == sorted(want) and got_m == want_m
    for k, w in want.items():
        x = np.asarray(got[k])
        if "pressure_level" in k or "300_700" in k:
            ok = np.isfinite(w)
            np.testing.assert_array_equal(np.isfinite(x), ok)
            np.testing.assert_allclose(x[ok], w[ok], rtol=0,
                                       atol=1e-12 * np.abs(w[ok]).max())
        else:
            np.testing.assert_array_equal(x, w)


def _w2_state(g, seed=0):
    """Williamson 2 (chip_smoke.w2_fields) at grid g with seeded noise of
    1 m and 1 m/s, numpy float64."""
    import chip_smoke

    depth, u, v = chip_smoke.w2_fields(g)
    rng = np.random.RandomState(seed)
    return (depth + rng.randn(*depth.shape), u + rng.randn(*u.shape),
            v + rng.randn(*v.shape))


def test_sw_step_on_card_matches_cpu(dev):
    """One C12 shallow-water step (c_sw scheme, hord 5, d2 0.12) from
    make_sw_stepper with no device (the card), float32: K1 twice and K3
    once, and the state as close to the CPU's float64 step as the CPU's
    float32 step is (parity.f32_rule)."""
    from fv3net_tpu_torch import parity
    from fv3net_tpu_torch.convert import sw_state_from_numpy
    from fv3net_tpu_torch.dycore import make_sw_stepper
    from fv3net_tpu_torch.grid import CubedSphereGrid
    from fv3net_tpu_torch.ops.cuda_filter import del4_filter_cuda

    g = CubedSphereGrid.make(n, halo=H)
    state = [np.asarray(a, np.float32) for a in _w2_state(g)]
    run, m = make_sw_stepper(g, 300.0)
    assert m.area_px.device.type == "cuda"
    k1, k3 = fv_tp_2d_cuda.launches, del4_filter_cuda.launches
    got = run(sw_state_from_numpy(state), 1)
    assert fv_tp_2d_cuda.launches == k1 + 2
    assert del4_filter_cuda.launches == k3 + 1
    assert got.delp.device.type == "cuda"
    refs = []
    for dtype in (torch.float32, torch.float64):
        run_cpu, _ = make_sw_stepper(g, 300.0, dtype=dtype, device="cpu")
        refs.append(run_cpu(sw_state_from_numpy(state, "cpu", dtype), 1))
    for k, (err, bound, _, _, finite) in parity.f32_rule(
            got, refs[:1], refs[1]).items():
        assert finite and err <= bound, (k, err, bound)


def test_sw_step_on_card_in_float64_raises(dev):
    """The kernels take float32 only: a float64 SW run on the card raises
    from K1's operand check, never running the plain transport."""
    from fv3net_tpu_torch.convert import sw_state_from_numpy
    from fv3net_tpu_torch.dycore import make_sw_stepper
    from fv3net_tpu_torch.grid import CubedSphereGrid

    g = CubedSphereGrid.make(n, halo=H)
    run, _ = make_sw_stepper(g, 300.0, dtype=torch.float64)
    launches = fv_tp_2d_cuda.launches
    with pytest.raises(TypeError, match="float32"):
        run(sw_state_from_numpy(_w2_state(g), dtype=torch.float64), 1)
    assert fv_tp_2d_cuda.launches == launches


def test_regrid_on_card(dev):
    """FregridLatLon.regrid of a host array with no device runs on the
    card; float32 within 1e-5 of the CPU's float64 regrid (the card's
    scatter-add is atomic: roundoff, not bit for bit), a constant field
    constant to 1e-6 where dst_area > 0, a CUDA tensor kept there."""
    from fv3net_tpu_torch.grid import CubedSphereGrid
    from fv3net_tpu_torch.regrid import FregridLatLon

    rg = FregridLatLon(CubedSphereGrid.make(n, halo=H), 24, 48)
    q = np.random.RandomState(9).randn(6, 3, n, n)
    got = rg.regrid(q.astype(np.float32))
    assert got.device.type == "cuda" and got.dtype == torch.float32
    want = rg.regrid(q, device="cpu")
    assert_close_scaled(got.cpu().numpy(), want.numpy(), 1e-5, "regrid")
    const = rg.regrid(torch.full((6, n, n), 5.0, device=dev))
    filled = const.cpu().numpy()[rg.dst_area.reshape(24, 48) > 0]
    np.testing.assert_allclose(filled, 5.0, rtol=1e-6)


@pytest.mark.parametrize("width", [12, 48, 192])
def test_filter_pair_entry_equals_table_entry(dev, width):
    """K3's exchanged-pair entry (the face mesh's) on [6, nz, N, N]: the
    same arithmetic as the table-reading entry, bit for bit; one launch."""
    from fv3net_tpu_torch.ops.cuda_filter import (
        del4_filter_cuda,
        del4_filter_pair_cuda,
    )

    rng = np.random.RandomState(width + 1)
    area = _t(1.0 + 0.1 * rng.rand(6, width, width), dev)
    apx = halo_exchange(area, H, fill="x")
    apy = halo_exchange(area, H, fill="y")
    q = _t(rng.randn(6, NZ, width, width), dev)
    qx = halo_exchange(q, H, fill="x").contiguous()
    qy = halo_exchange(q, H, fill="y").contiguous()
    launches = del4_filter_pair_cuda.launches
    got = del4_filter_pair_cuda(qx, qy, apx, apy, sw.FILTER_COEF, H)
    assert del4_filter_pair_cuda.launches == launches + 1
    assert torch.equal(got, del4_filter_cuda(q, apx, apy, sw.FILTER_COEF,
                                             H))


@pytest.mark.parametrize("width", [12, 48])
def test_filter_pair_entry_one_face(dev, width):
    """The pair entry on one face [1, nz, N, N] (a face-mesh rank's
    shape) against the plain scalar_filter of the whole cube on that face
    and against its own plain version, the JAX kernel test's tolerance."""
    from fv3net_tpu_torch.ops.cuda_filter import del4_filter_pair_cuda

    rng = np.random.RandomState(width + 2)
    area = _t(1.0 + 0.1 * rng.rand(6, width, width), dev)
    m = type("M", (), dict(
        n=width, halo=H, area_px=halo_exchange(area, H, fill="x"),
        area_py=halo_exchange(area, H, fill="y"), rarea=1.0 / area,
    ))
    q = _t(rng.randn(6, NZ, width, width), dev)
    want = sw.scalar_filter_plain(q, m, sw.FILTER_COEF)
    for f in range(6):
        args = [a[f:f + 1].contiguous() for a in (
            halo_exchange(q, H, fill="x"), halo_exchange(q, H, fill="y"),
            m.area_px, m.area_py)]
        got = del4_filter_pair_cuda(*args, sw.FILTER_COEF, H)
        torch.testing.assert_close(got[0], want[f], rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(
            got, sw.scalar_filter_pair_plain(*args, sw.FILTER_COEF, H),
            rtol=1e-4, atol=1e-5,
        )


def test_multiband_radiation_on_card_matches_cpu(dev):
    """MultibandRadiationDriver on a seeded C12 x 63 state on the card in
    float32: every output as close to the CPU's float64 driver as the
    CPU's float32 driver is (parity.f32_rule, F32_FACTOR), tensors on the
    card."""
    import datetime

    from fv3net_tpu_torch import parity
    from fv3net_tpu_torch.physics.radiation import MultibandRadiationDriver

    rng = np.random.RandomState(5)
    pe = np.linspace(100.0, 101325.0, NZ + 1)[None, :, None, None] * (
        1.0 + 0.01 * rng.rand(6, 1, n, n))
    delp = pe[:, 1:] - pe[:, :-1]
    p_lay = 0.5 * (pe[:, 1:] + pe[:, :-1])
    temp = 288.0 - 60.0 * (1.0 - p_lay / 101325.0) + rng.randn(*p_lay.shape)
    sphum = 0.012 * (p_lay / 101325.0) ** 3 * rng.rand(*p_lay.shape) + 1e-6
    ql = np.where(rng.rand(*p_lay.shape) < 0.3, 1e-4, 0.0)
    tsfc = 285.0 + 10.0 * rng.rand(6, n, n)
    land = (rng.rand(6, n, n) < 0.4).astype(np.float64)
    snow = 20.0 * rng.rand(6, n, n) * land
    lat = rng.uniform(-85.0, 85.0, (6, n, n))
    lon = rng.uniform(0.0, 360.0, (6, n, n))
    t = datetime.datetime(2016, 8, 1, 12)
    drv = MultibandRadiationDriver()
    drv.radupdate(t)

    def run(device, dtype):
        def c(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        return drv.gfs_radiation_driver(
            t, lon, lat, c(p_lay), c(delp), c(temp), c(sphum), c(tsfc),
            ql=c(ql), land_mask=c(land), snow=c(snow),
        )

    got = run(dev, torch.float32)
    assert all(v.device.type == "cuda" for v in got.values())
    rule = parity.f32_rule(got, [run("cpu", torch.float32)],
                           run("cpu", torch.float64))
    for k, (err, bound, _, _, finite) in rule.items():
        assert finite and err <= bound, (k, err, bound)


# --- the captured steps (fv3net_tpu_torch.graphs) ---------------------------

# launches of one C12 x 63 nonhydrostatic dt (chip_smoke.LAUNCHES_PER_DT):
# 5 transports x 6 substeps + 1 tracer, a vertical solve, 4 filters, a
# column chain and the fused C-grid half-stage a substep, 6 remaps
DT_LAUNCHES = {"fv_tp_2d_cuda": 31, "sim1_solver_cuda": 6,
               "del4_filter_cuda": 24, "column_pressures_cuda": 6,
               "ppm_remap_cuda": 6, "fv_tp_2d_multi5_cuda": 0,
               "c_sw_half_cuda": 6}


def _c12_stepper(dev, **flags):
    from fv3net_tpu_torch.dycore import hydro
    from fv3net_tpu_torch.grid import CubedSphereGrid

    run, m, _ = hydro.make_dycore_stepper(
        CubedSphereGrid.make(n, halo=H), NZ, 900.0, device=dev, **flags)
    return run, hydro.benchmark_state(n, NZ, 300.0, dev), torch.zeros(
        (6, n, n), device=dev)


def _launch_counts():
    from fv3net_tpu_torch.ops import _build, cuda_filter  # noqa: F401

    return {w.__name__: w.launches for w in _build.COUNTED.values()}


def _assert_states_equal(a, b, tag):
    for k, x, y in zip(a._fields, a, b):
        if x is not None:
            assert torch.equal(x, y), f"{tag} {k}: {(x - y).abs().max()}"


def test_replayed_dt_equals_eager(dev):
    """Two eager dts from one state agree bit for bit (no accumulation
    order changes between them at C12), and so do the replayed dt and
    two chained replays against two eager dts."""
    run, st, phis = _c12_stepper(dev)
    e1 = run.one_dt(st, phis)
    _assert_states_equal(e1, run.one_dt(st, phis), "eager twice")
    _assert_states_equal(run(st, phis, 1), e1, "replay")
    _assert_states_equal(run(st, phis, 2), run.one_dt(e1, phis), "2 dts")


def test_replay_moves_launch_counts(dev):
    """The first call (warm-up, capture, replay) and each later replay
    count one dt's launches a dt; the warm-up and the capture count
    none."""
    run, st, phis = _c12_stepper(dev)
    before = _launch_counts()
    run(st, phis, 1)
    mid = _launch_counts()
    run(st, phis, 3)
    after = _launch_counts()
    for k, per_dt in DT_LAUNCHES.items():
        assert mid[k] - before[k] == per_dt, k
        assert after[k] - mid[k] == 3 * per_dt, k


def test_donate_aliases_and_no_donate_copies(dev):
    run_d, st, phis = _c12_stepper(dev, donate=True)
    ptrs = [x.data_ptr() for x in st]
    s1 = run_d(st, phis, 1)
    s2 = run_d(s1, phis, 1)
    # the donated input's own buffers carry the result, call after call
    assert [x.data_ptr() for x in s1] == ptrs
    assert [x.data_ptr() for x in s2] == ptrs
    run, st, phis = _c12_stepper(dev)
    keep = [x.clone() for x in st]
    a = run(st, phis, 1)
    a_keep = [x.clone() for x in a]
    b = run(a, phis, 1)
    _assert_states_equal(st, type(st)(*keep), "input")
    _assert_states_equal(a, type(a)(*a_keep), "kept step k")
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(a, b))
    _assert_states_equal(s2, b, "donate vs not")


def test_fused_switch_is_part_of_the_key(dev):
    """A graph captured with the fused transport off is not replayed with
    it on: the second call captures anew, launches K6, and equals the
    eager fused dt."""
    from fv3net_tpu_torch.ops import advection

    run, st, phis = _c12_stepper(dev)
    off = run(st, phis, 1)
    advection.set_fused_transport(True)
    try:
        before = _launch_counts()
        on = run(st, phis, 1)
        after = _launch_counts()
        eager_on = run.one_dt(st, phis)
    finally:
        advection.set_fused_transport(False)
    assert after["fv_tp_2d_multi5_cuda"] - before["fv_tp_2d_multi5_cuda"] == 6
    assert after["fv_tp_2d_cuda"] - before["fv_tp_2d_cuda"] == 1
    assert len(run.graphed.captures) == 2
    _assert_states_equal(on, eager_on, "fused")
    _assert_states_equal(off, run.one_dt(st, phis), "unfused")


def _spread_equal(got, eager, again, tag):
    """got equals eager within the eager run-to-run spread (|eager -
    again|, element by element; bit for bit where two eager runs agree)."""
    for k in eager:
        bad = (got[k] - eager[k]).abs() > (eager[k] - again[k]).abs()
        assert not bool(bad.any()), f"{tag} {k}: {int(bad.sum())} values"


def test_compiled_loop_replays_and_keeps_diagnostics(dev, tmp_path):
    """Two replayed coupled steps (CompiledTimeLoop) against two eager
    full_steps from the same state, state and diagnostics; a diagnostic
    kept from step k is unchanged after step k+1."""
    from fv3net_tpu_torch import fit
    from fv3net_tpu_torch.runtime import compiled_loop, coupled_bench

    wrapper = _init_cuda(dev, physics_suite="gfs", do_radiation=True,
                         hydrostatic=False)
    _moist_state(wrapper, seed=4)
    mdl = wrapper.get_model()
    model = fit.load(coupled_bench.train_dense_artifact(
        str(tmp_path / "dense"), NZ, dev))
    loop = compiled_loop.CompiledTimeLoop(wrapper, ml_model=model)
    eager = loop._step_fn.eager

    def fields(st, diags):
        out = {k: x.clone() for k, x in st._asdict().items() if x is not None}
        out.update({f"diag {k}": v.clone() for k, v in diags.items()})
        return out

    kept = None
    for step in range(2):
        cosz, solcon = loop._astronomy()
        args = (mdl.phis, loop._tsfc, loop._on_device(mdl.total_precip),
                cosz, solcon)
        runs = [eager(type(mdl.state)(*(None if x is None else x.clone()
                                        for x in mdl.state)), *args)
                for _ in range(2)]
        diags = loop.step()
        got = fields(mdl.state, {k: q.data for k, q in diags.items()})
        _spread_equal(got, *(fields(r[0], r[3]) for r in runs),
                      f"step {step}")
        if kept is None:
            first, kept = diags, {k: q.data.clone() for k, q in diags.items()}
    for k, q in first.items():
        assert torch.equal(q.data, kept[k]), k


def test_compiled_loop_upload_waits_for_no_step(dev, tmp_path):
    """The loop copies cos zenith to the card from a pinned buffer without
    waiting for the stream (a copy from pageable memory waits, draining
    the steps in flight each step): an upload issued behind a long device
    op returns while the op runs; and three replayed steps equal, bit for
    bit, three whose cos zenith is copied from pageable memory."""
    from fv3net_tpu_torch import fit
    from fv3net_tpu_torch.runtime import compiled_loop, coupled_bench

    wrapper = _init_cuda(dev, physics_suite="gfs", do_radiation=True,
                         hydrostatic=False)
    _moist_state(wrapper, seed=5)
    mdl = wrapper.get_model()
    model = fit.load(coupled_bench.train_dense_artifact(
        str(tmp_path / "dense"), NZ, dev))
    loop = compiled_loop.CompiledTimeLoop(wrapper, ml_model=model)
    start = (type(mdl.state)(*(None if x is None else x.clone()
                               for x in mdl.state)),
             mdl.total_precip.clone(), mdl.time)
    loop.step()  # warm-up and capture
    torch.cuda.synchronize()

    host = np.random.RandomState(0).rand(6, n, n)
    torch.cuda._sleep(1 << 30)
    got = loop._upload(host)
    assert not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert torch.equal(got, loop._on_device(host))

    def three_steps():
        st, tp, t = start
        mdl.state = type(st)(*(None if x is None else x.clone() for x in st))
        mdl.total_precip, mdl.time = tp.clone(), t
        for _ in range(3):
            loop.step()
        torch.cuda.synchronize()
        return {k: x.clone() for k, x in mdl.state._asdict().items()
                if x is not None}

    pinned = three_steps()
    loop._upload = loop._on_device  # the pageable copy
    pageable = three_steps()
    for k, x in pinned.items():
        assert torch.equal(x, pageable[k]), k


# --- the last jitted entry points: the local mesh, the SW run, ppm_remap ---

# a shard's launches in one dt of the face mesh (chip_smoke's
# LAUNCHES_SPMD_FACE: K3 by its exchanged-pair entry) and of a tile
SHARD_LAUNCHES = {
    (6, 1, 1): {"fv_tp_2d": 31, "sim1_solver": 6, "del4_filter": 0,
                "del4_filter_pair": 24, "column_pressures": 12,
                "ppm_remap": 6, "c_sw_half": 0},
    (2, 2, 2): {"fv_tp_2d": 31, "sim1_solver": 6, "del4_filter": 0,
                "del4_filter_pair": 0, "column_pressures": 12,
                "ppm_remap": 6, "c_sw_half": 0},
}


def _local_c12(dev, layout):
    """A local mesh's C12 stepper on the card and the sharded benchmark
    state."""
    from fv3net_tpu_torch.dycore import hydro
    from fv3net_tpu_torch.grid import CubedSphereGrid
    from fv3net_tpu_torch.parallel import spmd_dycore
    from fv3net_tpu_torch.parallel.mesh import make_local_mesh
    from fv3net_tpu_torch.parallel.tiling import TileLayout

    mesh = make_local_mesh(layout)
    g = CubedSphereGrid.make(n, halo=H)
    if layout == (6, 1, 1):
        run, shard, gather = spmd_dycore.make_spmd_dycore_stepper(
            g, NZ, mesh, 900.0)
    else:
        run, shard, gather = spmd_dycore.make_tiled_spmd_dycore_stepper(
            g, NZ, mesh, TileLayout(n, H, *layout), 900.0)
    sharded, phis = shard(hydro.benchmark_state(n, NZ, 300.0, dev),
                          torch.zeros((6, n, n), device=dev))
    return mesh, run, gather, sharded, phis


def _fields(state):
    return {k: x for k, x in state._asdict().items() if x is not None}


@pytest.mark.parametrize("layout", [(6, 1, 1), (2, 2, 2)])
def test_local_mesh_replay_equals_eager(dev, layout):
    """The replayed dt of every shard (one CUDA graph, captured on the
    first call) against two eager dts of the local mesh (bit for bit
    where they agree), and two chained replays against two eager dts;
    the face mesh's eager dt against the single-process dt, within the
    spread of two of those."""
    mesh, run, gather, sh, ph = _local_c12(dev, layout)
    e1, e2 = (_fields(gather(run.one_dt(sh, ph))) for _ in range(2))
    _spread_equal(_fields(gather(run(sh, ph, 1))), e1, e2, "replay")
    two = gather(run.one_dt(run.one_dt(sh, ph), ph))
    _spread_equal(_fields(gather(run(sh, ph, 2))), _fields(two),
                  _fields(gather(run.one_dt(run.one_dt(sh, ph), ph))),
                  "two dts")
    assert len(run.graphed.graphs()) == 1
    if layout == (6, 1, 1):
        single, st, phis = _c12_stepper(dev)
        s1, s2 = (_fields(single.one_dt(st, phis)) for _ in range(2))
        for k in s1:  # the sharded dt within the single-process spread
            bad = (e1[k] - s1[k]).abs() > 4.0 * (s1[k] - s2[k]).abs()
            assert not bool(bad.any()), k


@pytest.mark.parametrize("layout", [(6, 1, 1), (2, 2, 2)])
def test_local_mesh_counts_each_shard(dev, layout):
    """An eager dt counts each shard's launches (mesh.launches) and all of
    them; the first call (warm-ups, capture, one replay) and each later
    replay count every shard's launches a dt, the warm-ups and the
    capture none."""
    from fv3net_tpu_torch.ops import _build

    mesh, run, _, sh, ph = _local_c12(dev, layout)
    per = SHARD_LAUNCHES[layout]
    every = {k: mesh.n_devices * c for k, c in per.items()}

    def counts():
        return {k: _build.COUNTED[k].launches for k in per}

    c0 = counts()
    run.one_dt(sh, ph)
    c1 = counts()
    assert all({k: d[k] for k in per} == per for d in mesh.launches)
    assert {k: c1[k] - c0[k] for k in per} == every
    run(sh, ph, 1)
    c2 = counts()
    run(sh, ph, 3)
    c3 = counts()
    assert {k: c2[k] - c1[k] for k in per} == every
    assert {k: c3[k] - c2[k] for k in per} == {k: 3 * c for k, c in
                                               every.items()}


def test_sw_run_replays_and_equals_eager(dev):
    """make_sw_stepper's run on the card: a CUDA graph of one step,
    replayed (one capture), within the spread of two eager steps; three
    replays count K1 six times and K3 three times."""
    from fv3net_tpu_torch.convert import sw_state_from_numpy
    from fv3net_tpu_torch.dycore import make_sw_stepper
    from fv3net_tpu_torch.grid import CubedSphereGrid
    from fv3net_tpu_torch.ops.cuda_filter import del4_filter_cuda

    g = CubedSphereGrid.make(n, halo=H)
    run, _ = make_sw_stepper(g, 300.0)
    st = sw_state_from_numpy([np.asarray(a, np.float32)
                              for a in _w2_state(g)])
    e1, e2 = (_fields(run.one_step(st)) for _ in range(2))
    _spread_equal(_fields(run(st, 1)), e1, e2, "SW replay")
    k1, k3 = fv_tp_2d_cuda.launches, del4_filter_cuda.launches
    run(st, 3)
    assert (fv_tp_2d_cuda.launches - k1, del4_filter_cuda.launches - k3) \
        == (6, 3)
    assert len(run.graphed.graphs()) == 1


def test_ppm_remap_unit_replays_k5(dev):
    """ops.remap.ppm_remap on the card: one capture a key (mappm's rules
    and the exact boundaries two keys), K5 in each replay (one launch a
    call), bit for bit with its eager body and within K5's tolerance of
    the plain remap."""
    rng = np.random.RandomState(41)
    w = np.cumsum(0.2 + rng.rand(NZ + 1, 6, n, n), axis=0)
    pe1 = 300.0 + (w - w[:1]) / (w[-1:] - w[:1]) * 1e5
    pe2 = pe1 * (1.0 + 0.04 * (rng.rand(1, 6, n, n) - 0.5))
    q, p1, p2 = (_t(a, dev) for a in (1.0 + 0.1 * rng.randn(NZ, 6, n, n),
                                      pe1, pe2))
    unit = remap.ppm_remap
    unit.graphed.captures.clear()
    for exact in (False, True, False):
        before = ppm_remap_cuda.launches
        got = unit(q, p1, p2, iv=1, kord=9, exact_boundaries=exact)
        assert ppm_remap_cuda.launches == before + 1
        eager = unit.eager(q, p1, p2, iv=1, kord=9, exact_boundaries=exact)
        assert torch.equal(got, eager)
        want = remap.ppm_remap_plain(q, p1, p2, iv=1, kord=9,
                                     exact_boundaries=exact)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert unit.captures() == 2
    unit.graphed.captures.clear()


def _c48_stepper(dev):
    """The C48 x 63 dt of bench.py (hord 5, kord 9, one tracer)."""
    from fv3net_tpu_torch.dycore import hydro
    from fv3net_tpu_torch.grid import CubedSphereGrid

    run, _, _ = hydro.make_dycore_stepper(
        CubedSphereGrid.make(48, halo=H), NZ, 900.0, device=dev)
    return run, hydro.benchmark_state(48, NZ, 300.0, dev), torch.zeros(
        (6, 48, 48), device=dev)


def test_marked_replay_equals_eager_and_writes_54_marks(dev):
    """A replayed C48 dt, its 54 marks captured in it, equals the eager dt
    (which writes the same 54) bit for bit; each replay writes its own
    54, which decode to one dycore.dt and its stages."""
    from fv3net_tpu_torch import tracing

    run, st, phis = _c48_stepper(dev)
    tracing.reset()
    eager = run.one_dt(st, phis)
    assert len(tracing.entries()) == 54
    replayed = run(st, phis, 1)  # warm-up, capture, one replay
    _assert_states_equal(replayed, eager, "marked replay")
    tracing.reset()
    run(st, phis, 3)
    ids = [i for i, _ in tracing.entries()]
    assert len(ids) == 3 * 54 and ids[:54] == ids[54:108] == ids[108:]
    names = [s.name for s in tracing.device_spans()]
    assert names.count("dycore.dt") == 3
    assert names.count("dycore.d_sw") == names.count("dycore.damping") == 18


def test_stage_spans_tile_the_dt(dev):
    """Over 20 replayed C48 dts, each timed by CUDA events: the stages'
    and the dt's self times sum to the dt's span, and the span is within
    2% of the event time (which adds the graph's copy-in and clone-out).
    A replay is in flight when the first timed dt is enqueued, as for
    every later one, so that no event pair holds the host's dispatch
    onto an idle device: without it the first dt on an H100 read 24.74 ms
    of span against 25.27 ms of events, 2.1% of the dt."""
    from fv3net_tpu_torch import tracing

    run, st, phis = _c48_stepper(dev)
    run(st, phis, 1)
    torch.cuda.synchronize()
    run(st, phis, 1)
    tracing.reset()
    events = []
    for _ in range(20):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        st = run(st, phis, 1)
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    spans = [s for s in tracing.device_spans() if s.name == "dycore.dt"]
    steps = tracing.per_step()
    assert len(spans) == 20 and set(steps) == {
        "dycore.dt", "dycore.c_sw", "dycore.d_sw", "dycore.riem_solver",
        "dycore.damping", "dycore.tracer_2d", "dycore.remap"}
    for k, (s, (a, b)) in enumerate(zip(spans, events)):
        tiled = sum(v[k] for v in steps.values())
        assert tiled == pytest.approx(s.ms, rel=1e-9)
        assert s.ms == pytest.approx(a.elapsed_time(b), rel=0.02), k


def test_replay_moves_exchange_counts(dev):
    """A replay adds the exchanges' calls and bytes and the spans' calls
    of one eager dt, on the card; the warm-up and the capture add none."""
    from fv3net_tpu_torch import tracing

    run, st, phis = _c12_stepper(dev)
    snap = tracing.COUNTS.snapshot()
    run.one_dt(st, phis)
    eager = tracing.COUNTS.since(snap)
    assert eager[("dycore.dt", "cuda")] == (1, 0)
    assert eager[("halo_exchange", "cuda")][1] > 0
    snap = tracing.COUNTS.snapshot()
    run(st, phis, 1)
    assert tracing.COUNTS.since(snap) == eager
    snap = tracing.COUNTS.snapshot()
    run(st, phis, 2)
    assert tracing.COUNTS.since(snap) == {
        k: (2 * c, 2 * b) for k, (c, b) in eager.items()}


def _c48_cell_stepper(dev, seed):
    """The benchmark cell's C48 x 63 dt (hord 6, kord 10, ptop 64.247), from
    bench.py's seeded state with seeded unit-normal winds besides, so that
    the dampers and the boundary rewrites act."""
    from fv3net_tpu_torch.dycore import hydro
    from fv3net_tpu_torch.grid import CubedSphereGrid

    ptop = 64.247
    run, _, _ = hydro.make_dycore_stepper(
        CubedSphereGrid.make(48, halo=H), NZ, 900.0, hord=6, kord=10,
        ptop=ptop, device=dev)
    st = hydro.benchmark_state(48, NZ, ptop, dev, seed=seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    st = st._replace(
        u=torch.randn(st.u.shape, generator=gen, device=dev),
        v=torch.randn(st.v.shape, generator=gen, device=dev))
    return run, st, torch.zeros((6, 48, 48), device=dev)


def _scatter_ms_per_dt(run, st, phis, dts=3):
    """Device ms a replayed dt of autograd's scatter-add
    (``indexing_backward_kernel``), from a trace of `dts` replays."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(dts):
            run(st, phis, 1)
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if "indexing_backward" in e.name) / 1e3 / dts


def test_cell_dt_equals_the_full_pool_boundary_form(dev, monkeypatch):
    """The replayed C48 dt with the boundary rewrites gathering only the
    boundary slots equals, field by field and bit for bit, the dt built
    and captured with the full-pool form (tests/test_torch_halo.py), and
    leaves no scatter-add in the replay."""
    from test_torch_halo import use_full_pool_form

    run, st, phis = _c48_cell_stepper(dev, seed=20261018)
    got = run(st, phis, 1)  # warm-up, capture, one replay
    assert all(bool(torch.isfinite(x).all()) for x in got if x is not None)
    assert _scatter_ms_per_dt(run, st, phis) <= 0.1
    del run
    use_full_pool_form(monkeypatch)
    run_ref, _, _ = _c48_cell_stepper(dev, seed=20261018)
    _assert_states_equal(got, run_ref(st, phis, 1), "full-pool form")
    assert _scatter_ms_per_dt(run_ref, st, phis) > 1.0


# --- the fused C-grid half-stage (ops/cuda_c_sw.py, csrc/c_sw.cu) -----------


def _c_sw_inputs(dev, width, nonhydro, terrain):
    """Inputs of ``_c_sw_half_3d`` at C<width> x 63: the benchmark state
    (nonhydrostatic, the cell's ptop) or the hydrostatic rest state with
    pt noise (ptop 300), seeded winds of ~10 m/s, phis None or seeded
    terrain, and the substep's shared exchanges."""
    from fv3net_tpu_torch.dycore import hydro
    from fv3net_tpu_torch.dycore.sw import SWMetrics
    from fv3net_tpu_torch.grid import CubedSphereGrid

    m = SWMetrics.make(CubedSphereGrid.make(width, halo=H), device=dev)
    rng = np.random.RandomState(width + 2 * nonhydro + terrain)
    if nonhydro:
        ptop = 64.247
        st = hydro.benchmark_state(width, NZ, ptop, dev, seed=width)
    else:
        ptop = 300.0
        st = hydro.rest_state(width, NZ, ptop, device=dev)
        st = st._replace(pt=st.pt + _t(rng.randn(*st.pt.shape), dev))
    st = st._replace(u=_t(10.0 * rng.randn(*st.u.shape), dev),
                     v=_t(10.0 * rng.randn(*st.v.shape), dev))
    phis = (_t(2e4 * rng.rand(6, width, width), dev) if terrain else None)
    return st, m, ptop, phis, hydro._exchanges(st, H)


@pytest.mark.parametrize("terrain", [False, True])
@pytest.mark.parametrize("nonhydro", [True, False])
@pytest.mark.parametrize("width", [12, 48])
def test_c_sw_half_kernels_match_the_torch_chain(dev, width, nonhydro,
                                                 terrain):
    """The fused half-stage (one count, three launches) against the torch
    chain on the same inputs on the card: uc and vc on every slot of
    their padded lattices within 1e-5 of the chain's largest value.  The
    tolerance: the kernels repeat the chain's float32 operations in its
    order (equal bit for bit with torch 2.11's kernels on the H100), but
    torch's own kernels may round a scalar division or a product and sum
    otherwise in another build, and the geopotential carries one ulp of
    the column's pressures to the winds as up to a few 1e-6 of their
    magnitude."""
    from fv3net_tpu_torch.dycore import hydro
    from fv3net_tpu_torch.ops import cuda_c_sw

    st, m, ptop, phis, exch = _c_sw_inputs(dev, width, nonhydro, terrain)
    before = cuda_c_sw.c_sw_half_cuda.launches
    got = hydro._c_sw_half_3d(st, m, 75.0, ptop, phis, *exch)
    assert cuda_c_sw.c_sw_half_cuda.launches == before + 1
    want = hydro._c_sw_half_chain(st, m, 75.0, ptop, phis, *exch)
    assert cuda_c_sw.c_sw_half_cuda.launches == before + 1
    for name, g, w in zip(("uc", "vc"), got, want):
        assert g.shape == w.shape == (6, NZ, width + 2 * H, width + 2 * H)
        assert bool(torch.isfinite(g).all()), name
        rel = float((g - w).abs().max() / w.abs().max())
        assert rel <= 1e-5, (name, rel)


def test_c_sw_half_wrapper_reads_nothing_on_the_host(dev):
    """After the first call (the tables staged), a call makes no host read
    and no host array into a tensor (tests/torch_parity.py), and gives the
    same bits; a float64 operand is refused."""
    from fv3net_tpu_torch.ops import cuda_c_sw
    from torch_parity import NoHostRead

    st, m, ptop, phis, exch = _c_sw_inputs(dev, 12, True, True)
    first = cuda_c_sw.c_sw_half_cuda(m, 75.0, ptop, phis, *exch)
    with NoHostRead(scalars=True):
        again = cuda_c_sw.c_sw_half_cuda(m, 75.0, ptop, phis, *exch)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    with pytest.raises(TypeError, match="float32"):
        cuda_c_sw.c_sw_half_cuda(m, 75.0, ptop, phis,
                                 *(x.double() for x in exch))


def test_c_sw_half_in_the_replayed_c48_cell_dt(dev):
    """The benchmark cell's C48 x 63 dt: ``COUNTED["c_sw_half"]`` moves by
    6 a dt, eager and replayed (the warm-up and the capture count none),
    and the replayed dt equals its eager call bit for bit."""
    from fv3net_tpu_torch.ops import cuda_c_sw

    def count():
        return cuda_c_sw.c_sw_half_cuda.launches

    run, st, phis = _c48_cell_stepper(dev, seed=2718281829)
    c0 = count()
    eager = run.one_dt(st, phis)
    assert count() - c0 == 6
    replayed = run(st, phis, 1)  # warm-up, capture, one replay
    assert count() - c0 == 12
    assert all(bool(torch.isfinite(x).all()) for x in replayed
               if x is not None)
    _assert_states_equal(replayed, eager, "replay")
    run(st, phis, 2)
    assert count() - c0 == 24
