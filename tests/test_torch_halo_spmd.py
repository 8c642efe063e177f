"""The face-mesh exchanges of fv3net_tpu_torch.parallel.halo_spmd over 6
gloo ranks on the CPU (tests/torch_spmd_worker.py, one face a rank,
float64).  Every local exchange, gathered over the ranks, equals the JAX
package's single-device exchange bit for bit (they are copies times
+-1), for each fill; the vjp of each staggered exchange equals the
single-process port's gather-form transpose (grid/halo_transpose.py) bit
for bit: both sum a pool entry's readers in (output, face, slot) order.
The single-process scalar exchange is transposed by autograd's
scatter-add, whose accumulation order is torch's own: there the sums of
the same two or three terms agree to SCALAR_RTOL (an ulp) of the field's
largest magnitude.  The exchange plans themselves are held against the JAX package's
in tests/test_torch_tiling_tables.py."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu.grid import halo as jhalo
from fv3net_tpu.grid import topology as jtopo
from fv3net_tpu_torch.grid import halo as thalo
from fv3net_tpu_torch.parallel import multihost

N, H = 8, 3
SCALAR_RTOL = 1e-15
WORKER = os.path.join(os.path.dirname(__file__), "torch_spmd_worker.py")


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    N_ = N + 2 * H

    def r(*shape):
        return rng.randn(*shape)

    return dict(
        h=np.int64(H),
        q=r(6, 2, N, N), u=r(6, 2, N + 1, N), v=r(6, 2, N, N + 1),
        uc=r(6, 2, N, N + 1), vc=r(6, 2, N + 1, N),
        ct_q=r(6, 2, N_, N_), ct_u=r(6, 2, N_ + 1, N_),
        ct_v=r(6, 2, N_, N_ + 1), ct_uc=r(6, 2, N, N + 1),
        ct_vc=r(6, 2, N + 1, N), ct_su=r(6, 2, N + 1, N),
        ct_sv=r(6, 2, N, N + 1), ct_cu=r(6, 2, N_, N_ + 1),
        ct_cv=r(6, 2, N_ + 1, N_), f2d=1.0 + rng.rand(6, N, N),
        area=1.0 + rng.rand(6, N, N),
    )


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("halo_spmd")
    inp = _inputs()
    np.savez(d / "inp.npz", **inp)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    proc = multihost.spawn(
        [WORKER, "exchanges", str(d / "inp.npz"), str(d)], 6,
        str(d / "store"), timeout_s=300, env=env,
    )
    proc.wait()
    outs = [torch.load(d / f"exchanges_rank{r}.pt") for r in range(6)]
    return inp, outs


def _gathered(outs, key, i=None):
    parts = [o[key] if i is None else o[key][i] for o in outs]
    return torch.cat(parts, dim=0).numpy()


@pytest.mark.parametrize("fill", ["none", "x", "y"])
def test_scalar_exchanges_match_jax(ranks, fill):
    inp, outs = ranks
    want = np.asarray(jhalo.halo_exchange(jnp.asarray(inp["q"]), H, fill))
    for key in (f"scalar_{fill}", f"strips_{fill}"):
        got = _gathered(outs, key)
        if fill == "none":
            # cube-corner slots are placeholders, consumed by no stencil
            _, _, _, mask = jtopo.halo_source_indices(N, H)
            sel = np.broadcast_to(~mask[:, None], got.shape)
            np.testing.assert_array_equal(got[sel], want[sel], err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("kind", ["dgrid", "cgrid_x", "cgrid_y", "canon",
                                  "avg"])
def test_staggered_exchanges_match_jax(ranks, kind):
    inp, outs = ranks
    if kind == "dgrid":
        want = jhalo.halo_exchange_dgrid(
            jnp.asarray(inp["u"]), jnp.asarray(inp["v"]), H
        )
    elif kind.startswith("cgrid"):
        want = jhalo.halo_exchange_cgrid(
            jnp.asarray(inp["uc"]), jnp.asarray(inp["vc"]), H,
            fill=kind[-1],
        )
    elif kind == "canon":
        want = jhalo.canonicalize_cgrid_boundary(
            jnp.asarray(inp["uc"]), jnp.asarray(inp["vc"])
        )
    else:
        want = jhalo.average_dgrid_boundary(
            jnp.asarray(inp["u"]), jnp.asarray(inp["v"])
        )
    for i in range(2):
        np.testing.assert_array_equal(
            _gathered(outs, kind, i), np.asarray(want[i]), err_msg=f"{kind}"
        )


def _t(a):
    return torch.as_tensor(a)


@pytest.mark.parametrize("kind", ["scalar_x", "scalar_y", "dgrid",
                                  "cgrid_x", "cgrid_y", "canon", "avg"])
def test_vjps_match_single_process_transpose(ranks, kind):
    inp, outs = ranks
    if kind.startswith("scalar"):
        fill = kind[-1]
        args, ct = (_t(inp["q"]),), (_t(inp["ct_q"]),)
        fn = lambda a: thalo.halo_exchange(a, H, fill)  # noqa: E731
        _, vjp = torch.func.vjp(fn, *args)
        want = vjp(ct[0])
    else:
        if kind == "dgrid":
            args, ct = (inp["u"], inp["v"]), (inp["ct_u"], inp["ct_v"])
            fn = lambda a, b: thalo.halo_exchange_dgrid(a, b, H)  # noqa
        elif kind.startswith("cgrid"):
            fill = kind[-1]
            args, ct = (inp["uc"], inp["vc"]), (inp["ct_cu"], inp["ct_cv"])
            fn = lambda a, b: thalo.halo_exchange_cgrid(a, b, H, fill)  # noqa
        elif kind == "canon":
            args, ct = (inp["uc"], inp["vc"]), (inp["ct_uc"], inp["ct_vc"])
            fn = thalo.canonicalize_cgrid_boundary
        else:
            args, ct = (inp["u"], inp["v"]), (inp["ct_su"], inp["ct_sv"])
            fn = thalo.average_dgrid_boundary
        _, vjp = torch.func.vjp(fn, *map(_t, args))
        want = vjp(tuple(map(_t, ct)))
    got = [o[f"vjp_{kind}"] for o in outs]
    for i, w in enumerate(want):
        g = torch.cat([x[i] for x in got], dim=0)
        if kind.startswith("scalar"):
            err = float((g - w).abs().max())
            assert err <= SCALAR_RTOL * float(w.abs().max()), err
        else:
            assert torch.equal(g, w), (
                f"{kind}[{i}]: max |diff| {(g - w).abs().max():.3e}"
            )


def test_each_exchange_is_one_message_round(ranks):
    _, outs = ranks
    # 6 scalar + 1 D + 2 C + canon + avg forward, 2 + 1 + 2 + 1 + 1
    # transposed (each a forward and a backward round)
    assert {o["calls"] for o in outs} == {11 + 2 * 7}


def test_mesh_and_runtime_helpers(ranks):
    """shard_state, global_mean (an all_reduce), make_global_array and
    process_local_faces on each rank of the 6-rank face mesh."""
    inp, outs = ranks
    want_mean = (inp["f2d"] * inp["area"]).sum() / inp["area"].sum()
    for f, o in enumerate(outs):
        assert torch.equal(o["shard_q"], torch.as_tensor(inp["q"][f:f + 1]))
        assert torch.equal(o["shard_x"], torch.ones(3))
        assert torch.equal(o["global_array"],
                           torch.as_tensor(inp["q"][f:f + 1]))
        assert o["local_faces"] == [f]
        assert abs(float(o["global_mean"]) - want_mean) <= 1e-14 * abs(
            want_mean)
