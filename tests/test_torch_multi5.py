"""fv3net_tpu_torch's fused-transport pieces against the JAX package: the
plain fv_tp_2d_multi5 against the Pallas fv_tp_2d_multi5 in interpret
mode (the inputs and tolerance of tests/test_pallas_kernels.py:287-346,
float32) and against the JAX package's five-call wiring
(dycore/hydro.py:423-452) in float64; the set_fused_transport switch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
