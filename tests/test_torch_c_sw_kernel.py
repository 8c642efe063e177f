"""The fused C-grid half-stage (ops/cuda_c_sw.py, csrc/c_sw.cu) on a
machine without a GPU: the composed tables its kernels read the C-grid
canonicalisation and exchanges through, and which tensors take the
kernels.  The kernels themselves are held against the torch chain on the
card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from fv3net_tpu_torch.dycore import hydro
from fv3net_tpu_torch.grid import CubedSphereGrid, halo
from fv3net_tpu_torch.ops import _build, cuda_c_sw

torch.set_num_threads(1)

H, NZ = 3, 4


def _own_pair(n, seed):
    """Random stored C winds uc [6, NZ, n, n+1], vc [6, NZ, n+1, n]."""
    rng = np.random.RandomState(seed)
    return (torch.as_tensor(rng.randn(6, NZ, n, n + 1).astype(np.float32)),
            torch.as_tensor(rng.randn(6, NZ, n + 1, n).astype(np.float32)))


def _through_tables(uc, vc, n):
    """The four lattices read through cgrid_canon_gather_flat: each slot
    the coefficient times the stored value its code names."""
    N = n + 2 * H
    src, coef = halo.cgrid_canon_gather_flat(n, H, torch.device("cpu"))
    own = torch.zeros(12, NZ, N, N)  # [kind * 6 + g] on the padded lattice
    own[:6, :, H:H + n, H:H + n + 1] = uc
    own[6:, :, H:H + n + 1, H:H + n] = vc
    own = own.reshape(12, NZ, N * N)
    s = src.long()
    out = own[s // (N * N), :, s % (N * N)]  # [4, 6, N, N, NZ]
    return out.permute(0, 1, 4, 2, 3) * coef[:, :, None]


@pytest.mark.parametrize("n", [6, 12])
@pytest.mark.parametrize("lattice", ["uc fill x", "vc fill y", "vc fill x",
                                     "uc fill y"])
def test_cgrid_tables_reproduce_canonicalize_and_exchange(n, lattice):
    """Each of the four lattices equals canonicalize_cgrid_boundary then
    halo_exchange_cgrid (cropped to [N, N]), bit for bit, on every slot."""
    N = n + 2 * H
    uc, vc = _own_pair(n, seed=n)
    ucc, vcc = halo.canonicalize_cgrid_boundary(uc, vc)
    fill = lattice[-1]
    ux, vx = halo.halo_exchange_cgrid(ucc, vcc, H, fill=fill)
    want = ux[..., :, :N] if lattice.startswith("uc") else vx[..., :N, :]
    o = ["uc fill x", "vc fill y", "vc fill x", "uc fill y"].index(lattice)
    got = _through_tables(uc, vc, n)[o]
    assert got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))


def test_cgrid_table_codes_name_own_faces():
    """Every code names an x-face (J in [h, h+n), I in [h, h+n]) or a
    y-face (J in [h, h+n], I in [h, h+n)) of the padded lattice, and every
    coefficient is -1, 0 or 1."""
    n = 12
    N = n + 2 * H
    src, coef = halo.cgrid_canon_gather_flat(n, H, torch.device("cpu"))
    assert src.dtype == torch.int32 and coef.dtype == torch.float32
    assert src.shape == coef.shape == (4, 6, N, N)
    s = src.long()
    kind, g = s // (6 * N * N), s // (N * N) % 6
    J, I = s % (N * N) // N, s % N
    assert set(kind.unique().tolist()) == {0, 1} and g.max() == 5
    x, y = kind == 0, kind == 1
    assert bool(((J[x] >= H) & (J[x] < H + n)).all())
    assert bool(((I[x] >= H) & (I[x] <= H + n)).all())
    assert bool(((J[y] >= H) & (J[y] <= H + n)).all())
    assert bool(((I[y] >= H) & (I[y] < H + n)).all())
    assert set(coef.unique().tolist()) <= {-1.0, 0.0, 1.0}


@pytest.fixture(scope="module")
def c6():
    """A C6 state, its metrics and the substep's shared exchanges."""
    g = CubedSphereGrid.make(6, halo=H)
    from fv3net_tpu_torch.dycore.sw import SWMetrics

    m = SWMetrics.make(g, device="cpu")
    st = hydro.benchmark_state(6, NZ, 300.0, device="cpu", seed=3)
    rng = np.random.RandomState(4)
    st = st._replace(
        u=torch.as_tensor(rng.randn(*st.u.shape).astype(np.float32)),
        v=torch.as_tensor(rng.randn(*st.v.shape).astype(np.float32)))
    phis = torch.as_tensor(100.0 * rng.rand(6, 6, 6).astype(np.float32))
    return st, m, phis, hydro._exchanges(st, H)


class _OnCard:
    """A stand-in for a CUDA tensor: the predicate reads only is_cuda."""

    is_cuda = True


def _stand_in(monkeypatch):
    """The CPU as the fused kernels' device (the predicate reads a CPU
    tensor as a CUDA one), the kernels a recorder."""
    calls = []

    def record(*args):
        calls.append(args)
        return "fused"

    fused = hydro._c_sw_fused
    monkeypatch.setattr(hydro, "_c_sw_fused",
                        lambda x, m: fused(_OnCard() if x.device.type ==
                                           "cpu" else x, m))
    monkeypatch.setattr(cuda_c_sw, "c_sw_half_cuda", record)
    return calls


def test_cpu_tensors_take_the_torch_chain(c6):
    """On CPU tensors the predicate is false and the half-stage is the
    torch chain, bit for bit: no launch counted, the library never
    loaded."""
    st, m, phis, exch = c6
    assert not hydro._c_sw_fused(st.delp, m)
    assert hydro._c_sw_fused(_OnCard(), m)
    before = cuda_c_sw.c_sw_half_cuda.launches
    uc, vc = hydro._c_sw_half_3d(st, m, 75.0, 300.0, phis, *exch)
    assert uc.shape == vc.shape == (6, NZ, 12, 12)
    assert bool(torch.isfinite(uc[:, :, H:-H, H:-H]).all())
    want = hydro._c_sw_half_chain(st, m, 75.0, 300.0, phis, *exch)
    assert torch.equal(uc, want[0]) and torch.equal(vc, want[1])
    assert cuda_c_sw.c_sw_half_cuda.launches == before
    assert _build.COUNTED["c_sw_half"] is cuda_c_sw.c_sw_half_cuda


def test_face_level_tensors_of_the_device_take_the_kernels(c6, monkeypatch):
    """With the CPU standing in for the card, face-level metrics outside a
    mesh reach the kernels' wrapper with the half-stage's arguments."""
    st, m, phis, exch = c6
    calls = _stand_in(monkeypatch)
    assert hydro._c_sw_fused(st.delp, m)
    assert hydro._c_sw_half_3d(st, m, 75.0, 300.0, phis, *exch) == "fused"
    (args,) = calls
    assert args[0] is m and args[1:4] == (75.0, 300.0, phis)
    assert all(a is b for a, b in zip(args[4:], exch))


@pytest.mark.parametrize("where", ["spmd_mode", "tile metrics"])
def test_meshes_and_tiles_take_the_torch_chain(c6, monkeypatch, where):
    """Under spmd_mode, or with a tile's metrics (edge flags set), the
    device's tensors still take the torch chain, bit for bit the chain
    the CPU runs."""
    import dataclasses

    st, m, phis, exch = c6
    want = hydro._c_sw_half_chain(st, m, 75.0, 300.0, phis, *exch)
    calls = _stand_in(monkeypatch)
    if where == "tile metrics":
        mt = dataclasses.replace(m, edge_w=True, edge_e=True, edge_s=True,
                                 edge_n=True)
        assert not hydro._c_sw_fused(st.delp, mt)
        got = hydro._c_sw_half_3d(st, mt, 75.0, 300.0, phis, *exch)
    else:
        # a one-member axis that is never asked to exchange: the
        # predicate reads only whether an axis is set
        with halo.spmd_mode(object()):
            assert not hydro._c_sw_fused(st.delp, m)
        # the predicate sees a mesh; the chain's own exchanges read
        # halo.spmd_active and stay single-process
        monkeypatch.setattr(hydro, "spmd_active", lambda: True)
        got = hydro._c_sw_half_3d(st, m, 75.0, 300.0, phis, *exch)
    assert calls == []
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrapper_refuses_cpu_tensors(c6):
    st, m, phis, exch = c6
    with pytest.raises(ValueError, match="CUDA"):
        cuda_c_sw.c_sw_half_cuda(m, 75.0, 300.0, phis, *exch)
    assert _build._lib is None
