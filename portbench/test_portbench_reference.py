"""The frozen reference is the port's plain dt: at C12 x 8 on the CPU in
float64, with terrain, in bench.py's scheme (hord 5, kord 9) and in the
configuration's, one dt of ``portbench/reference`` matches the
port's eager ``run.one_dt`` within the port's own CPU tests' rule
(``tests/test_torch_dycore.py``: max |got - want| <= 1e-9 max |want| a
field, the float64 operators agreeing to ~1e-15 and w amplifying that
to ~1e-11 of its magnitude), with the fused-transport switch off and on;
and the reference's blocked remap gives the unblocked one's values."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.reference import hydro as ref  # noqa: E402
from portbench.reference import remap as ref_remap  # noqa: E402

RTOL = 1e-9
n, NZ, DT, PTOP = 12, 8, 900.0, 300.0
CFG = json.loads((Path(__file__).resolve().parent / "configs"
                  / "C48x63.json").read_text())
SCHEMES = [(5, 9, PTOP), (CFG["hord"], CFG["kord"], CFG["ptop"])]


def _state(seed=0, ptop=PTOP):
    rng = np.random.RandomState(seed)
    ak, bk = ref.hybrid_coefficients(NZ, ptop)
    pe = (ak + bk * 1e5).numpy()
    delp = np.broadcast_to((pe[1:] - pe[:-1])[None, :, None, None],
                           (6, NZ, n, n)) * (1 + 0.01 * rng.rand(6, NZ, n, n))
    pt = 300.0 + 5.0 * rng.randn(6, NZ, n, n)
    u = 5.0 * rng.randn(6, NZ, n + 1, n)
    v = 5.0 * rng.randn(6, NZ, n, n + 1)
    q = 0.01 * rng.rand(2, 6, NZ, n, n)
    t = [torch.as_tensor(a, dtype=torch.float64) for a in (delp, pt, u, v, q)]
    st = ref.DycoreState(*t)
    pe_f = ref._interface_pressures(st.delp, ptop)
    return st._replace(w=0.1 * torch.as_tensor(rng.randn(6, NZ, n, n)),
                       delz=ref.hydrostatic_dz(st.delp, st.pt, pe_f))


@pytest.mark.parametrize("hord,kord,ptop", SCHEMES)
@pytest.mark.parametrize("fused", [False, True])
def test_reference_dt_matches_the_ports_eager_dt(fused, hord, kord, ptop):
    from fv3net_tpu_torch.dycore import hydro
    from fv3net_tpu_torch.grid.geometry import CubedSphereGrid
    from fv3net_tpu_torch.ops import advection

    st = _state(ptop=ptop)
    phis = 2000.0 * torch.as_tensor(np.abs(np.random.RandomState(1).randn(
        6, n, n)))
    run, _, _ = hydro.make_dycore_stepper(
        CubedSphereGrid.make(n, halo=3), NZ, DT, k_split=1, n_split=6,
        hord=hord, kord=kord, ptop=ptop, dtype=torch.float64, device="cpu")
    advection.set_fused_transport(fused)
    try:
        want = run.one_dt(hydro.DycoreState(*st), phis)
    finally:
        advection.set_fused_transport(False)
    one_dt, _ = ref.make_one_dt(n, NZ, 3, DT, 1, 6, hord, kord, 0.12, ptop,
                                torch.float64, "cpu")
    got = one_dt(st, phis)
    for k in ref.DycoreState._fields:
        g, w = getattr(got, k), getattr(want, k)
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        assert bool(torch.isfinite(g).all()), k
        assert err <= RTOL * scale, f"{k}: {err:.3e} > {RTOL} * {scale:.3e}"


def test_blocked_remap_equals_one_block(monkeypatch):
    rng = np.random.RandomState(3)
    w = np.cumsum(0.2 + rng.rand(6, NZ + 1, n, n), axis=1)
    pe1 = torch.as_tensor(PTOP + (w - w[:, :1]) / (w[:, -1:] - w[:, :1])
                          * 1e5)
    pe2 = torch.as_tensor(np.sort(pe1.numpy() * (1 + 0.001 * rng.rand(
        6, NZ + 1, n, n)), axis=1))
    pe2[:, :1], pe2[:, -1:] = pe1[:, :1], pe1[:, -1:]
    q = torch.as_tensor(1.0 + rng.randn(6, NZ, n, n))
    whole = ref_remap.remap_levels(q, pe1, pe2, 1, 9)
    # rows of 5 columns a block: three blocks, the last ragged
    monkeypatch.setattr(ref_remap, "BLOCK_BYTES",
                        5 * NZ * NZ * 6 * n * q.element_size())
    assert torch.equal(ref_remap.remap_levels(q, pe1, pe2, 1, 9), whole)
