"""K7 and K8's launch plans (fv3net_tpu_torch/probe.py::affine_plan,
::stencil_plan), walked thread by thread in numpy.

The kernels (csrc/probe.cu) cannot run here, so these mirrors follow
their control flow over every thread of the plan's grid: K7's unrolled
and remainder grid-stride loops over the float4 body and its scalar loop
over the head and tail; K8's warps over (row, group of segments), each
lane's chunk of 1 or 4 columns, the neighbours taken from the adjacent
lanes (the shuffles) or loaded by the segment's edge lanes and at the
row's wrap.  On the odd shapes the card checks and on x (and y) starting
0-3 floats past a 16-byte boundary they show that every element is
written exactly once, that every float4 access is 16-byte aligned, and
that the result equals the plain version bit for bit.  The constants
are read from the source."""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import fv3net_tpu_torch
from fv3net_tpu_torch import probe

SRC = (Path(fv3net_tpu_torch.__file__).parent / "csrc" / "probe.cu"
       ).read_text()
F32 = np.float32
BASE = 0x7F3A_0000_0000  # a 16-byte (indeed 256-byte) aligned address
ODD = [(1, 1), (2, 1), (1, 2), (3, 7), (17, 33), (256, 256), (4099, 4097)]


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def test_constants_match_the_source():
    assert probe.THREADS == _const("kThreads")
    assert probe.UNROLL == _const("kUnroll")
    assert _const("kWarp") == 32


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(F32)


def walk_affine(x, px, py, plan):
    """(y, writes) of affine_kernel over the grid of `plan`."""
    head, nvec, blocks = plan
    n = x.size
    tile = probe.UNROLL * probe.THREADS
    y = np.full(n, np.nan, F32)
    writes = np.zeros(n, np.int64)

    def vectors(i):  # float4 number i of the body, in x and in y
        e = head + 4 * i
        assert not ((px + 4 * e) % 16).any() and not ((py + 4 * e) % 16).any()
        e = (e[:, None] + np.arange(4)).ravel()
        np.add.at(writes, e, 1)
        y[e] = x[e] * F32(2) + F32(1)

    tid = np.arange(probe.THREADS)
    b = np.arange(blocks)[:, None]
    i = (b * tile + tid).ravel()  # every thread of the grid
    t = np.tile(tid, blocks)
    while True:  # whole tiles, kUnroll vectors a thread
        on = i - t + tile <= nvec
        if not on.any():
            break
        for u in range(probe.UNROLL):
            vectors(i[on] + u * probe.THREADS)
        i[on] += blocks * tile
    while True:  # the partial tile, by its block's threads in turn
        on = i < nvec
        if not on.any():
            break
        vectors(i[on])
        i[on] += probe.THREADS
    r, body = (b * probe.THREADS + tid).ravel(), 4 * nvec
    while True:  # the scalar head and tail
        on = r < n - body
        if not on.any():
            break
        e = np.where(r[on] < head, r[on], r[on] + body)
        np.add.at(writes, e, 1)
        y[e] = x[e] * F32(2) + F32(1)
        r += blocks * probe.THREADS
    return y, writes


def walk_stencil(x, px, py, plan):
    """(y, writes) of stencil_kernel<vec> over the grid of `plan`."""
    vec, k, blocks = plan
    rows, cols = x.shape
    xf = x.ravel()
    y = np.full(x.size, np.nan, F32)
    writes = np.zeros(x.size, np.int64)
    row_warps = blocks * probe.WARPS // k
    warp = np.arange(row_warps * k)  # the grid's other warps idle
    nch, span = cols // vec, probe.UNROLL * 32
    lane = np.arange(32)
    jj = np.arange(vec)
    for j in itertools.count():
        r = warp // k + j * row_warps
        if not (r < rows).any():
            break
        for m in itertools.count():
            g = (warp % k) * span + m * k * span
            act = (r < rows) & (g < nch)
            if not act.any():
                break
            row = (r * cols)[:, None]
            ch = [g[:, None] + s * 32 + lane for s in range(probe.UNROLL)]
            ok = [act[:, None] & (c < nch) for c in ch]
            v = []
            for c, o in zip(ch, ok):  # loads (0 past the row's end)
                e = np.where(o, row + c * vec, 0)
                if vec == 4:
                    assert not ((px + 4 * e[o]) % 16).any()
                    assert not ((py + 4 * e[o]) % 16).any()
                v.append(np.where(o[..., None], xf[e[..., None] + jj], F32(0)))
            for c, o, vs in zip(ch, ok, v):
                # __shfl_up_sync / __shfl_down_sync: lane 0 and lane 31
                # keep their own value
                left = np.concatenate([vs[:, :1, -1], vs[:, :-1, -1]], 1)
                right = np.concatenate([vs[:, 1:, 0], vs[:, -1:, 0]], 1)
                col = c * vec
                edge = o & (lane == 0)
                left = np.where(edge, xf[np.where(
                    edge, row + np.where(col == 0, cols - 1, col - 1), 0)],
                    left)
                wrap = col + vec == cols
                edge = o & ((lane == 31) | wrap)
                right = np.where(edge, xf[np.where(
                    edge, row + np.where(wrap, 0, col + vec), 0)], right)
                lefts = np.concatenate([left[..., None], vs[..., :-1]], -1)
                rights = np.concatenate([vs[..., 1:], right[..., None]], -1)
                out = (vs + lefts) + rights
                e = (row + col)[..., None] + jj
                np.add.at(writes, e[o], 1)
                y[e[o]] = out[o]
    return y.reshape(x.shape), writes.reshape(x.shape)


# caps on the grid (probe.WAVES x the blocks the card holds at once): one
# block and three (the grid-stride loops go round many times), 64, and the
# H100's (128 waves of 132 SMs x 8)
CAPS = (1, 3, 64, 135168)


@pytest.mark.parametrize("shape", ODD)
def test_affine_plan_writes_each_element_once(shape):
    x = _x(shape, 0).ravel()
    n = x.size
    want = probe.affine_plain(torch.as_tensor(x)).numpy()
    for ax, ay, res in itertools.product(range(4), range(4), CAPS):
        if n > 4096 and (res != 64 or ax != ay):
            continue  # thousands of numpy steps; the small shapes cover it
        px, py = BASE + 4 * ax, BASE + 64 + 4 * ay
        plan = probe.affine_plan(n, px & 15, py & 15, res)
        head, nvec, blocks = plan
        assert 1 <= blocks <= res
        if ax == ay:  # the wrapper gives y the offset of x
            assert head == min(n, (4 - ax) % 4)
            assert nvec == (n - head) // 4
        else:
            assert head == nvec == 0
        y, writes = walk_affine(x, px, py, plan)
        assert (writes == 1).all(), (shape, ax, ay, res)
        np.testing.assert_array_equal(y, want)


def test_affine_plan_at_the_probe_shape():
    # [256, 256]: 16384 float4, 16 tiles of 4 x 256
    assert probe.affine_plan(256 * 256, 0, 0, 135168) == (
        0, 16384, 16)
    # [16384, 16384]: a block a tile under the H100's cap; one wave of
    # resident blocks loops over the tiles
    assert probe.affine_plan(16384 ** 2, 0, 0, 135168) == (
        0, 16384 ** 2 // 4, 65536)
    assert probe.affine_plan(16384 ** 2, 0, 0, 1056)[2] == 1056


@pytest.mark.parametrize(
    "shape", ODD + [(4, 1024), (1, 4096), (2, 1000), (12, 1040)])
def test_stencil_plan_writes_each_element_once(shape):
    x = _x(shape, 1)
    want = probe.stencil_plain(torch.as_tensor(x)).numpy()
    for ax, ay, res in itertools.product(range(4), (0, 1), CAPS):
        if x.size > 20000 and (res != 64 or ay or ax > 1):
            continue  # thousands of numpy steps; the small shapes cover it
        px, py = BASE + 4 * ax, BASE + 4 * ay
        plan = probe.stencil_plan(*shape, px & 15, py & 15, (res, res))
        vec, k, blocks = plan
        assert vec == (4 if shape[1] % 4 == 0 and ax == ay == 0 else 1)
        assert 1 <= blocks <= res and 1 <= k
        y, writes = walk_stencil(x, px, py, plan)
        assert (writes == 1).all(), (shape, ax, ay, res)
        np.testing.assert_array_equal(y, want)


def test_stencil_plan_maps_warps_to_rows_and_segments():
    # [256, 256]: 64 float4 a row, one group; a warp a row, 32 blocks
    assert probe.stencil_plan(256, 256, 0, 0, (67584, 84480)) == (
        4, 1, 32)
    # one long row: its 8 groups to 8 warps
    assert probe.stencil_plan(1, 4096, 0, 0, (67584, 84480)) == (
        4, 8, 1)
    # [16384, 16384]: 32 groups a row, a warp each
    assert probe.stencil_plan(16384, 16384, 0, 0, (67584, 84480)) == (
        4, 32, 65536)
    # a misaligned start: single columns, the grid at its cap
    assert probe.stencil_plan(16384, 16384, 4, 0, (67584, 990)) == (
        1, 128, 990)


def test_stencil_plan_refuses_columns_past_32_bits():
    with pytest.raises(ValueError, match="2\\^31"):
        probe.stencil_plan(1, 2 ** 31, 0, 0, (1056, 1056))
    assert probe.stencil_plan(3, 2 ** 31 - 1, 0, 0, (8, 8))[0] == 1


def test_variant_sources_change_only_the_unroll():
    """kernel_variants.py's probe variants: the package's source with
    kUnroll set, the package's own first."""
    from fv3net_tpu_torch import kernel_variants

    jobs = kernel_variants._probe_jobs()
    assert [j[0] for j in jobs] == [
        f"probe u{u}" for u in kernel_variants.PROBE_UNROLLS]
    assert jobs[0][1] == SRC
    for (name, src, *_), u in zip(jobs, kernel_variants.PROBE_UNROLLS):
        assert f"constexpr int kUnroll = {u};" in src
        assert src.replace(f"kUnroll = {u};", "kUnroll = 4;") == SRC
