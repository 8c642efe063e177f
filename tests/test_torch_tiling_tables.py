"""The exchange plans of fv3net_tpu_torch.parallel (tiling.py's compressed
plans and halo_spmd.py's face-mesh plans: host numpy copied from the JAX
package) against the JAX package's, bit for bit, for the layouts of
tests/test_tiling_tables.py; ``apply_plan_numpy`` of both on the same
seeded pools; and the per-rank runtime tables (``RankExchange``, what a
rank of the process group runs) emulated for every rank against
``apply_plan_numpy``."""

import numpy as np
import pytest

from fv3net_tpu.parallel import halo_spmd as jhs
from fv3net_tpu.parallel import tiling as jtl
from fv3net_tpu_torch.parallel import halo_spmd as ths
from fv3net_tpu_torch.parallel import tiling as ttl

N_, H_ = 12, 3
LAYOUTS = [(6, 2, 2), (2, 2, 2), (6, 1, 1)]


def _plans(mod, lay):
    """Every plan builder of a tiling module at a layout, by name."""
    out = {f"scalar_{f}": (mod.scalar_halo_plan(lay, f),)
           for f in ("none", "x", "y")}
    out["dgrid"] = mod.dgrid_halo_plans(lay)
    for f in ("x", "y"):
        out[f"cgrid_{f}"] = mod.cgrid_halo_plans(lay, f)
    out["canon"] = mod.canon_cgrid_plans(lay)
    out["avg"] = tuple(p for pair in mod.avg_dgrid_plans(lay) for p in pair)
    out["extend1"] = (mod.extend1_plan(lay),)
    return out


def _assert_plan_equal(a, b, name):
    assert a.out_shape == b.out_shape, name
    for f in ("local_tbl", "local_sign", "final_map"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, (name, f)
        np.testing.assert_array_equal(x, y, err_msg=f"{name} {f}")
    assert len(a.rounds) == len(b.rounds), name
    for i, (ra, rb) in enumerate(zip(a.rounds, b.rounds)):
        assert ra.perm == rb.perm, (name, i)
        np.testing.assert_array_equal(ra.tbl, rb.tbl, err_msg=name)
        np.testing.assert_array_equal(ra.sign, rb.sign, err_msg=name)


def _pool_size(plan):
    """Largest source index of the plan + 1 (the pools' width)."""
    tb = ttl.compressed_plan_tables(plan)
    return int(tb.loc.max()) + 1


def _emulate(plans, pools):
    """Every rank's RankExchange.forward, the messages passed by hand."""
    D, P = pools.shape[0], pools.shape[-1]
    tables = [ttl.compressed_plan_tables(p) for p in plans]
    rxs = [ths.RankExchange(tables, d, P) for d in range(D)]
    outs = []
    for d, rx in enumerate(rxs):
        parts = [np.zeros(1), pools[d][rx.own_loc] * rx.own_sign]
        for g in sorted(rx.recv):
            loc, sign = rxs[g].send[d]
            parts.append(pools[g][loc] * sign)
        buf = np.concatenate(parts)
        assert buf.size == rx.buf_size
        outs.append([buf[f].reshape(s) for f, s in zip(rx.final,
                                                       rx.out_shapes)])
    return [np.stack([o[t] for o in outs]) for t in range(len(plans))]


@pytest.mark.parametrize("FYX", LAYOUTS, ids=lambda l: "F{}Y{}X{}".format(*l))
def test_tiled_plans_bitwise_equal_jax(FYX):
    tp = _plans(ttl, ttl.TileLayout(N_, H_, *FYX))
    jp = _plans(jtl, jtl.TileLayout(N_, H_, *FYX))
    assert set(tp) == set(jp)
    for name in jp:
        for a, b in zip(tp[name], jp[name]):
            _assert_plan_equal(a, b, name)
    np.testing.assert_array_equal(
        ttl.tile_inv_corner_mult(ttl.TileLayout(N_, H_, *FYX)),
        jtl.tile_inv_corner_mult(jtl.TileLayout(N_, H_, *FYX)),
    )


@pytest.mark.parametrize("FYX", LAYOUTS, ids=lambda l: "F{}Y{}X{}".format(*l))
def test_apply_plan_numpy_and_rank_tables(FYX):
    lay = ttl.TileLayout(N_, H_, *FYX)
    rng = np.random.RandomState(sum(FYX))
    for name, plans in _plans(ttl, lay).items():
        P = max(_pool_size(p) for p in plans)
        pools = rng.randn(lay.D, 2, P)
        jplans = _plans(jtl, jtl.TileLayout(N_, H_, *FYX))[name]
        emulated = _emulate(plans, pools[:, 0])
        for t, (p, jp) in enumerate(zip(plans, jplans)):
            got = ttl.apply_plan_numpy(p, pools)
            np.testing.assert_array_equal(
                got, jtl.apply_plan_numpy(jp, pools), err_msg=name
            )
            np.testing.assert_array_equal(
                emulated[t], got[:, 0], err_msg=f"{name} ranks"
            )


@pytest.mark.parametrize("n", [8, 12])
def test_face_mesh_plans_bitwise_equal_jax(n):
    h = H_
    for fill in ("none", "x", "y"):
        tplan, tshape = ths._exchange_plan(n, h, fill)
        jplan, jshape = jhs._exchange_plan(n, h, fill)
        assert tshape == jshape and set(tplan) == set(jplan)
        for blk in jplan:
            for ra, rb in zip(tplan[blk], jplan[blk]):
                assert ra.perm == rb.perm
                np.testing.assert_array_equal(ra.tbl_stack, rb.tbl_stack)
    builders = {
        "scalar": lambda m: [m._scalar_full_plan(n, h, f)
                             for f in ("none", "x", "y")],
        "dgrid": lambda m: list(m._dgrid_plans(n, h)),
        "cgrid": lambda m: [p for f in ("x", "y")
                            for p in m._cgrid_plans(n, h, f)],
        "canon": lambda m: list(m._canon_plans(n)),
        "avg": lambda m: [p for pair in m._avg_plans(n) for p in pair],
    }
    rng = np.random.RandomState(n)
    for name, build in builders.items():
        for a, b in zip(build(ths), build(jhs)):
            assert a.out_shape == b.out_shape, name
            np.testing.assert_array_equal(a.local_tbl, b.local_tbl)
            np.testing.assert_array_equal(a.local_sign, b.local_sign)
            assert len(a.rounds) == len(b.rounds), name
            for ra, rb in zip(a.rounds, b.rounds):
                assert ra.perm == rb.perm, name
                np.testing.assert_array_equal(ra.tbl, rb.tbl)
                np.testing.assert_array_equal(ra.sign, rb.sign)
            # the global tables reproduce the plan's rounds on a pool
            tb = ths.pool_plan_tables(a)
            pool = rng.randn(6, int(tb.loc.max()) + 1)
            want = a.local_sign * np.take_along_axis(pool, a.local_tbl, 1)
            for rnd in a.rounds:
                send = rnd.sign * np.take_along_axis(pool, rnd.tbl, 1)
                for g, f in rnd.perm:
                    want[f] += send[g]
            got = np.where(tb.sign != 0, tb.sign * pool[
                np.where(tb.src >= 0, tb.src, 0), tb.loc], 0.0)
            np.testing.assert_array_equal(got, want, err_msg=name)
