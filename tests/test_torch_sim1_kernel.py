"""K2 (csrc/sim1.cu) on the CPU: a numpy mirror of the kernel's column
slabs -- tiles of TC consecutive columns over all faces, the ragged last
tile, the interior reads of the halo-padded pem, pm and ws, the
level-parallel phases, the per-column recurrences and the scratch slabs
reused as their values die -- held against the plain sim1_solver and the
JAX package's jnp sim1_solver and Pallas kernel (interpret mode) in
float64; sim1_solve's halo contract on the CPU; the wrapper's refusals."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fv3net_tpu_torch
from fv3net_tpu.dycore import riemann as jr
from fv3net_tpu.ops.pallas_sim1 import sim1_solver_pallas
from fv3net_tpu_torch import kernel_times, kernel_variants
from fv3net_tpu_torch.constants import (
    CP_AIR, CV_AIR, RDGAS, REFERENCE_SURFACE_PRESSURE as P00,
)
from fv3net_tpu_torch.dycore import riemann as tr
from fv3net_tpu_torch.ops.cuda_sim1 import sim1_solver_cuda

torch.set_num_threads(1)

CSRC = Path(fv3net_tpu_torch.__file__).parent / "csrc"
GAMMA = CP_AIR / CV_AIR
DT = 150.0
# f64: the mirror runs the plain form's expressions in the plain order;
# what differs is roundoff of the level recurrences (~1e-15 relative)
RTOL = 1e-12


def _constants(name):
    """The kernel's integer constants, evaluated from its source."""
    env = {}
    text = (CSRC / name).read_text()
    for line in re.findall(r"^constexpr int ([^;(]+);", text, re.M):
        for decl in line.split(","):
            key, expr = (s.strip() for s in decl.split("=", 1))
            env[key] = eval(expr, {}, dict(env))
    return env


K = _constants("sim1.cu")


def _columns(n, nz, seed):
    """Physically plausible columns (dz < 0, dm > 0, pt > 0), float64,
    as tests/test_torch_riemann.py builds them."""
    rng = np.random.RandomState(seed)
    pe = np.sort(
        np.linspace(300.0, 1.0e5, nz + 1)[:, None, None]
        * (1.0 + 0.01 * rng.rand(6, nz + 1, n, n)),
        axis=1,
    )
    delp = pe[:, 1:] - pe[:, :-1]
    pt = np.clip(300.0 + 30.0 * rng.randn(6, nz, n, n), 200.0, 400.0)
    t = torch.as_tensor
    pm = tr.layer_mean_pressure(t(delp), t(pe)).numpy()
    dz = tr.hydrostatic_dz(t(delp), t(pt), t(pe)).numpy() * (
        1.0 + 0.05 * rng.randn(6, nz, n, n)
    )
    w = 2.0 * rng.randn(6, nz, n, n)
    ws = 0.5 * rng.randn(6, n, n)
    return [delp / 9.80665, pt, dz, w, pe, pm, ws]


def _pad(a, h, seed):
    """a inside a halo of h cells of garbage (NaN and huge values)."""
    if h == 0:
        return a
    rng = np.random.RandomState(seed)
    out = 1e30 * rng.randn(*a.shape[:-2], a.shape[-2] + 2 * h,
                           a.shape[-1] + 2 * h)
    out[..., : h // 2 + 1, :] = np.nan
    out[..., h:-h, h:-h] = a
    return out


# --- K2's column slabs, mirrored in numpy -----------------------------------
#
# Block b takes columns [b TC, b TC + TC) of the F n^2 columns flattened
# as (face, j, i); the tile keeps each column's face, its position j n + i
# and its padded position (j + h) N + i + h.  Shared memory is one array
# laid out as the kernel lays it out: dm, pt, dz, w and the scratch slabs
# x1, x2, x3 (nz levels each) and ws (1), slab[k TC + c]; x1 takes pm,
# then pe' in place, then pem[k + 1] (copied after (b)), then a_dn and the
# Thomas factors in place; (g) reads pm once more from the field.  Slots
# of a ragged tile's missing columns stay NaN and are never read.


def _tile(b, F, n, h):
    TC = K["TC"]
    cols = min(TC, F * n * n - b * TC)
    col = b * TC + np.arange(cols)
    face, pos = col // (n * n), col % (n * n)
    pos_pad = (pos // n + h) * (n + 2 * h) + pos % n + h
    return cols, face, pos, pos_pad


def _load(slab, field, levels, face, pos):
    """slab[k, c] = field[face[c], k].flat[pos[c]] for the tile's columns."""
    flat = field.reshape(field.shape[0], levels, -1)
    cols = len(face)
    slab[:levels, :cols] = flat[face, :, pos].T


def sim1_slab_mirror(dt, dm, pt, dz, w, pem, pm, ws, h, p_fac=0.05):
    TC = K["TC"]
    F, nz, n, _ = dm.shape
    L = nz * TC
    smem_floats = (7 * nz + 1) * TC  # sim1.cu's smem_bytes / 4
    w2 = np.full(dm.shape, np.nan)
    dz2 = np.full(dm.shape, np.nan)
    ppe = np.full((F, nz + 1, n, n), np.nan)
    t1g = 2.0 * GAMMA * dt * dt
    blocks = -(-F * n * n // TC)
    ragged = 0
    for b in range(blocks):
        cols, face, pos, pos_pad = _tile(b, F, n, h)
        ragged += cols < TC
        smem = np.full(smem_floats, np.nan)

        def slab(i, levels):  # slab i of the layout, [levels, TC]
            return smem[i * L : i * L + levels * TC].reshape(levels, TC)

        dm_s, pt_s, dz_s, w_s, x1, x2, x3 = (slab(i, nz) for i in range(7))
        ws_s = slab(7, 1)
        assert 7 * L + TC == smem_floats
        # (a) the tile's inputs, pm into x1; pm, pem and ws through the
        # padded positions
        for s, f, lv, p in ((dm_s, dm, nz, pos), (pt_s, pt, nz, pos),
                            (dz_s, dz, nz, pos), (w_s, w, nz, pos),
                            (x1, pm, nz, pos_pad),
                            (ws_s, ws[:, None], 1, pos_pad)):
            _load(s, f, lv, face, p)
        c = np.s_[:cols]
        # (b) level-parallel: pe' (over pm, in place), then g_rat and dd
        rr = -dm_s[:, c] * RDGAS * pt_s[:, c] / dz_s[:, c]
        x1[:, c] = P00 * (rr / P00) ** GAMMA - x1[:, c]
        g = dm_s[:-1, c] / dm_s[1:, c]
        x2[:-1, c] = g
        x3[:-1, c] = 3.0 * (x1[:-1, c] + g * x1[1:, c])
        x3[-1, c] = 3.0 * x1[-1, c]
        # pem levels 1..nz into x1 (pe' is dead)
        x1[:, c] = pem.reshape(F, nz + 1, -1)[face, 1:, pos_pad].T
        # (c) the pp sweep, one thread a column (here: all columns of a
        # level at once); x3[k] becomes pp[k + 1]
        bet = np.ones(cols)
        pp_k = np.zeros(cols)
        for k in range(nz):
            bb = 2.0 * (1.0 + x2[k, c]) if k < nz - 1 else 2.0
            gm = 0.0 if k == 0 else x2[k - 1, c] / bet
            bet = bb - gm
            pp_k = (x3[k, c] - pp_k) / bet
            x3[k, c] = pp_k
        # (d) level-parallel: a_dn into x1, r into x2
        pp_hi = x3[:, c].copy()
        pp_lo = np.concatenate([np.zeros((1, cols)), pp_hi[:-1]])
        r = dm_s[:, c] * w_s[:, c] + dt * (pp_hi - pp_lo)
        a_dn = np.empty((nz, cols))
        a_dn[:-1] = t1g / (dz_s[:-1, c] + dz_s[1:, c]) * (
            x1[:-1, c] + pp_hi[:-1]
        )
        p1 = t1g / dz_s[nz - 1, c] * (x1[-1, c] + pp_hi[-1])
        a_dn[-1] = p1
        r[-1] = r[-1] - p1 * ws_s[0, c]
        x1[:, c] = a_dn
        x2[:, c] = r
        # (e) Thomas: factors into x1, w into x2; (f) ppe[k + 1] into x3
        a_up, wp, bet = np.zeros(cols), np.zeros(cols), np.ones(cols)
        for k in range(nz):
            a_dn_k, dmk = x1[k, c].copy(), dm_s[k, c]
            if k == 0:
                gk = np.zeros(cols)
                bet = dmk - a_dn_k
            else:
                gk = a_up / bet
                bet = dmk - (a_up + a_dn_k + a_up * gk)
            wp = (x2[k, c] - a_up * wp) / bet
            x1[k, c] = gk
            x2[k, c] = wp
            a_up = a_dn_k
        w_next = wp
        for k in range(nz - 2, -1, -1):
            w_next = x2[k, c] - x1[k + 1, c] * w_next
            x2[k, c] = w_next
        acc = np.zeros(cols)
        for k in range(nz):
            acc = acc + dm_s[k, c] * (x2[k, c] - w_s[k, c]) / dt
            x3[k, c] = acc
        # (g) level-parallel: dz2; w2, dz2 and ppe stored once each
        prev = np.concatenate([np.zeros((1, cols)), x3[:-1, c]])
        pmk = pm.reshape(F, nz, -1)[face, :, pos_pad].T  # from the field
        p_lay = pmk + (prev + 2.0 * x3[:, c]) / 3.0
        p_lay = np.maximum(p_lay, p_fac * pmk)
        for out, val, lv in (
            (ppe, np.concatenate([prev, x3[-1:, c]]), nz + 1),
            (w2, x2[:, c], nz),
            (dz2, -(dm_s[:, c] * RDGAS * pt_s[:, c] / P00)
             * (p_lay / P00) ** (-CV_AIR / CP_AIR), nz),
        ):
            flat = out.reshape(F, lv, -1)
            assert np.isnan(flat[face, :, pos]).all()  # each once
            flat[face, :, pos] = val.T
    return (w2, dz2, ppe), ragged


def _padded_args(args, h):
    dm, pt, dz, w, pe, pm, ws = args
    return (dm, pt, dz, w, _pad(pe, h, 1), _pad(pm, h, 2), _pad(ws, h, 3))


@pytest.mark.parametrize("h", [0, 3])
@pytest.mark.parametrize("n,nz", [(6, 2), (6, 13), (12, 2), (12, 13)])
def test_sim1_slab_mirror_equals_plain(n, nz, h):
    """The mirror on the padded pem/pm/ws (garbage and NaN in their halos)
    equals the plain sim1_solver on the interior to RTOL of each output's
    scale, in float64: n = 6 ends in a ragged tile (216 columns), n = 12
    has tiles that run over two faces (144 columns a face)."""
    args = _columns(n, nz, seed=10 * n + nz)
    got, ragged = sim1_slab_mirror(DT, *_padded_args(args, h), h)
    assert ragged == (1 if (6 * n * n) % K["TC"] else 0)
    want = tr.sim1_solver(DT, *map(torch.as_tensor, args))
    for g, w_ in zip(got, want):
        w_ = w_.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w_, rtol=0,
                                   atol=RTOL * np.abs(w_).max())


@pytest.mark.parametrize("reference", ["jnp", "pallas_interpret"])
def test_sim1_slab_mirror_matches_jax(reference):
    """The mirror, reading padded pem/pm/ws, against the JAX package's
    sim1_solver and its Pallas kernel in interpret mode at n = 6."""
    n, nz, h = 6, 13, 3
    args = _columns(n, nz, seed=5)
    jargs = [jnp.asarray(a) for a in args]
    want = (jr.sim1_solver(DT, *jargs) if reference == "jnp"
            else sim1_solver_pallas(DT, *jargs, interpret=True))
    got, _ = sim1_slab_mirror(DT, *_padded_args(args, h), h)
    for g, w_ in zip(got, want):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g, w_, rtol=0,
                                   atol=1e-11 * np.abs(w_).max())


@pytest.mark.parametrize("h", [1, 3])
def test_sim1_solve_halo_on_cpu_is_the_interior(h):
    """sim1_solve(..., halo=h) on padded pem, pm and ws equals sim1_solver
    on their interior, bit for bit (the CPU slices them)."""
    args = [torch.as_tensor(a) for a in _columns(6, 5, seed=h)]
    padded = [torch.as_tensor(a) for a in _padded_args(
        [a.numpy() for a in args], h)]
    for g, w_ in zip(tr.sim1_solve(DT, *padded, halo=h),
                     tr.sim1_solver(DT, *args)):
        assert torch.equal(g, w_)


def test_sim1_slab_fits_the_card():
    """Four 32-column tiles of 63 levels fit an SM's 228 KB of shared
    memory (227 KB a block), each tile one warp of recurrences."""
    TC, threads = K["TC"], K["kThreads"]
    tile = -(-4 * (3 * TC + 1) // 16) * 16  # the static ColumnTile
    block = 4 * (7 * 63 + 1) * TC + tile
    assert TC & (TC - 1) == 0 and TC % 32 == 0 and threads % TC == 0
    assert block <= 232448 and 4 * (block + 1024) <= 233472
    # the largest nz the entry point takes (its -1 above)
    assert 4 * (7 * 258 + 1) * TC + tile <= 232448
    assert 4 * (7 * 259 + 1) * TC + tile > 232448


def test_sim1_wrapper_refuses():
    c = torch.zeros(6, 3, 4, 4)
    pe = torch.zeros(6, 4, 10, 10)
    with pytest.raises(ValueError, match="CUDA"):
        sim1_solver_cuda(1.0, c, c, c, c, pe, torch.zeros(6, 3, 10, 10),
                         torch.zeros(6, 10, 10), halo=3)
    with pytest.raises(ValueError, match="halo"):
        sim1_solver_cuda(1.0, c, c, c, c, pe, c, c[:, 0], halo=-1)


@pytest.mark.parametrize("name",
                         list(kernel_variants.SLAB_VARIANTS["sim1.cu"]))
def test_sim1_kernel_variants_sources(name):
    """Each design variant of K2 (fv3net_tpu_torch/kernel_variants.py) is
    the kernel's source with some integer constants changed or some
    switches off; the first is the package's own kernel."""
    src = (CSRC / "sim1.cu").read_text()
    ints, off = kernel_variants.SLAB_VARIANTS["sim1.cu"][name]
    out = kernel_variants.slab_variant_source(src, ints, off)
    for key, value in ints.items():
        assert f"constexpr int {key} = {value};" in out
    for key in off:
        assert f"constexpr bool {key} = false;" in out
    assert out.count("= false;") == len(off)
    if name == next(iter(kernel_variants.SLAB_VARIANTS["sim1.cu"])):
        assert ints == {k: K[k] for k in ints} and off == ()
        assert out == src
    with pytest.raises(ValueError, match="no"):
        kernel_variants.slab_variant_source(src, ints, ("kOther",))


def test_kernel_times_sim1_inputs():
    """kernel_times.py's K2 columns: the gas law's signs, monotone
    interface pressures, float32; the step's call on the padded fields
    equals the plain solve on the interior (CPU)."""
    rng = np.random.RandomState(0)
    args = kernel_times._sim1_inputs(rng, 4)
    assert [a.shape for a in args] == [(6, 63, 4, 4)] * 4 + [
        (6, 64, 4, 4), (6, 63, 4, 4), (6, 4, 4)]
    assert all(a.dtype == np.float32 for a in args)
    assert (args[0] > 0).all() and (args[2] < 0).all()
    assert (np.diff(args[4], axis=1) > 0).all()
    t = [torch.as_tensor(a) for a in args]
    call = kernel_times._step_sim1_call(torch, tr, t)
    for g, w_ in zip(call(), tr.sim1_solver(DT, *t)):
        assert torch.equal(g, w_)
