"""K4 (csrc/column.cu) on the CPU: a numpy mirror of the kernel's column
slabs -- tiles of TC consecutive columns over all faces of the padded
field, the ragged last tile, the sequential prefix sum one thread a
column, then runs of levels, each carrying powf and logf down from its
top interface --
held against the plain column_pressures_plain, the JAX package's jnp chain
and its Pallas kernel (interpret mode) in float64, with garbage and NaN in
halo-corner columns."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fv3net_tpu_torch
from fv3net_tpu.constants import KAPPA, REFERENCE_SURFACE_PRESSURE as P00
from fv3net_tpu.dycore.riemann import layer_mean_pressure
from fv3net_tpu.ops.pallas_column import column_pressures_pallas
from fv3net_tpu_torch import kernel_variants
from fv3net_tpu_torch.ops import cuda_column

torch.set_num_threads(1)

CSRC = Path(fv3net_tpu_torch.__file__).parent / "csrc"
PTOP = 300.0


def _constants(name):
    """The kernel's integer constants, evaluated from its source."""
    env = {}
    text = (CSRC / name).read_text()
    for line in re.findall(r"^constexpr int ([^;(]+);", text, re.M):
        for decl in line.split(","):
            key, expr = (s.strip() for s in decl.split("=", 1))
            env[key] = eval(expr, {}, dict(env))
    return env


K = _constants("column.cu")


def _dp(shape, seed, corners=True):
    """Seeded thicknesses; with `corners`, the halo-corner columns of a
    padded field hold garbage (a negative thickness) and NaN, as the C
    half-stage's padded delpc may."""
    dp = 900.0 + 200.0 * np.random.RandomState(seed).rand(*shape)
    if corners:
        dp[:, :, 0, 0] = -1e6
        dp[:, :, 0, -1] = np.nan
        dp[:, :, -1, :2] = np.nan
    return dp


# --- K4's column slabs, mirrored in numpy -----------------------------------
#
# Block b takes columns [b TC, b TC + TC) of the F Y X columns flattened as
# (face, y, x).  Shared memory is one array laid out as the kernel lays it
# out: dp (nz levels) and pe (nz + 1), slab[k TC + c].  In the last phase
# kThreads / TC threads a column each take a run of ceil(nz / runs)
# consecutive layers, start with powf and logf at the run's top interface
# and carry them down the run.


def column_slab_mirror(dp, ptop):
    TC, runs = K["TC"], K["kThreads"] // K["TC"]
    F, nz, Y, X = dp.shape
    yx = Y * X
    L = nz * TC
    pe = np.full((F, nz + 1, Y, X), -7.0)  # sentinel: each stored once
    pi = np.full(dp.shape, -7.0)
    pm = np.full(dp.shape, -7.0)
    pe_f, pi_f, pm_f = (a.reshape(F, -1, yx) for a in (pe, pi, pm))
    blocks = -(-F * yx // TC)
    ragged = 0
    tops = 0  # powf/logf at a run's top interface
    length = -(-nz // runs)
    with np.errstate(invalid="ignore", divide="ignore"):
        for b in range(blocks):
            cols = min(TC, F * yx - b * TC)
            ragged += cols < TC
            col = b * TC + np.arange(cols)
            face, pos = col // yx, col % yx
            smem = np.full((2 * nz + 1) * TC, np.nan)  # smem_bytes / 4
            dp_s = smem[:L].reshape(nz, TC)
            pe_s = smem[L:].reshape(nz + 1, TC)
            c = np.s_[:cols]
            # 1. the dp slab
            dp_s[:, c] = dp.reshape(F, nz, yx)[face, :, pos].T
            # 2. the prefix sum, sequential, one thread a column
            acc = np.zeros(cols)
            pe_s[0, c] = acc + ptop
            for k in range(nz):
                acc = acc + dp_s[k, c]
                pe_s[k + 1, c] = acc + ptop
            # 3. the runs (all columns of a run at once)
            assert (pe_f[face, 0, pos] == -7.0).all()
            pe_f[face, 0, pos] = pe_s[0, c]
            for run in range(runs):
                k0, k1 = run * length, min(nz, run * length + length)
                if k0 >= k1:
                    continue
                tops += 1
                pe_lo = pe_s[k0, c]
                pik_lo = (pe_lo / P00) ** KAPPA
                ln_lo = np.log(pe_lo)
                for k in range(k0, k1):
                    d, pe_hi = dp_s[k, c], pe_s[k + 1, c]
                    pik_hi = (pe_hi / P00) ** KAPPA
                    ln_hi = np.log(pe_hi)
                    for out, lv, v in (
                        (pe_f, k + 1, pe_hi),
                        (pi_f, k, (pik_hi * pe_hi - pik_lo * pe_lo)
                         / ((1.0 + KAPPA) * d)),
                        (pm_f, k, d / (ln_hi - ln_lo)),
                    ):
                        assert (out[face, lv, pos] == -7.0).all()
                        out[face, lv, pos] = v
                    pe_lo, pik_lo, ln_lo = pe_hi, pik_hi, ln_hi
    assert tops == blocks * min(runs, -(-nz // length))
    return (pe, pi, pm), ragged


def _jnp_chain(dp):
    pe = PTOP + jnp.concatenate(
        [jnp.zeros_like(dp[:, :1]), jnp.cumsum(dp, axis=1)], axis=1
    )
    pik = (pe / P00) ** KAPPA
    pi = (pik[:, 1:] * pe[:, 1:] - pik[:, :-1] * pe[:, :-1]) / (
        (1.0 + KAPPA) * dp
    )
    return pe, pi, layer_mean_pressure(dp, pe)


def _assert_close(got, want, rtol):
    """Equal NaN pattern; elsewhere within rtol (relative, per value)."""
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol)


@pytest.mark.parametrize("shape", [
    (6, 2, 12, 12),   # C6 padded by 3: 864 columns, 27 tiles exactly
    (6, 13, 12, 12),
    (6, 2, 18, 18),   # C12 padded by 3: 1944 columns, a ragged last tile
    (6, 13, 18, 18),
    (6, 5, 8, 13),    # Y != X, tiles over rows of 13, ragged
    (6, 1, 5, 5),     # one layer
])
def test_column_slab_mirror_equals_plain(shape):
    """The mirror equals column_pressures_plain in float64 (1e-12; the
    same prefix sum in the same order), garbage and NaN columns
    included, which pass through without raising."""
    dp = _dp(shape, seed=sum(shape))
    (pe, pi, pm), ragged = column_slab_mirror(dp, PTOP)
    assert ragged == (1 if (6 * shape[2] * shape[3]) % K["TC"] else 0)
    want = cuda_column.column_pressures_plain(torch.as_tensor(dp), PTOP)
    for g, w_ in zip((pe, pi, pm), want):
        _assert_close(g, w_.numpy(), 1e-12)
    assert np.isnan(pi[:, :, 0, -1]).all()
    assert np.isfinite(pe[:, :, 2:-1, 2:-1]).all()


@pytest.mark.parametrize("reference", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("shape", [(6, 13, 8, 16), (6, 7, 18, 18)])
def test_column_slab_mirror_matches_jax(reference, shape):
    """The mirror against the JAX package's jnp chain and its Pallas
    column kernel in interpret mode (tests/test_torch_column.py's
    tolerance: pi differences large products)."""
    dp = _dp(shape, seed=shape[1], corners=False)
    if reference == "jnp":
        want = _jnp_chain(jnp.asarray(dp))
    else:
        want = column_pressures_pallas(jnp.asarray(dp), PTOP, interpret=True)
    got, _ = column_slab_mirror(dp, PTOP)
    for g, w_ in zip(got, want):
        _assert_close(g, w_, 1e-13)


def test_column_slab_fits_the_card():
    """A 32-column tile of 63 levels takes 16 KB: thirteen blocks an SM;
    a run of a column is at most 16 of its 63 layers."""
    TC, threads = K["TC"], K["kThreads"]
    tile = -(-4 * (3 * TC + 1) // 16) * 16  # the static ColumnTile
    block = 4 * (2 * 63 + 1) * TC + tile
    assert TC & (TC - 1) == 0 and TC % 32 == 0 and threads % TC == 0
    assert 13 * (block + 1024) <= 233472
    assert -(-63 // (threads // TC)) == 16
    assert 4 * (2 * 905 + 1) * TC + tile <= 232448  # the largest nz
    assert 4 * (2 * 906 + 1) * TC + tile > 232448


@pytest.mark.parametrize("name",
                         list(kernel_variants.SLAB_VARIANTS["column.cu"]))
def test_column_kernel_variants_sources(name):
    """Each design variant of K4 (fv3net_tpu_torch/kernel_variants.py) is
    the kernel's source with some integer constants changed or some
    switches off; the first is the package's own kernel."""
    src = (CSRC / "column.cu").read_text()
    ints, off = kernel_variants.SLAB_VARIANTS["column.cu"][name]
    out = kernel_variants.slab_variant_source(src, ints, off)
    for key, value in ints.items():
        assert f"constexpr int {key} = {value};" in out
    for key in off:
        assert f"constexpr bool {key} = false;" in out
    assert out.count("= false;") == len(off)
    if name == next(iter(kernel_variants.SLAB_VARIANTS["column.cu"])):
        assert ints == {k: K[k] for k in ints} and off == ()
        assert out == src
    with pytest.raises(ValueError, match="no"):
        kernel_variants.slab_variant_source(src, ints, ("kOther",))