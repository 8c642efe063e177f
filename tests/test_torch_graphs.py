"""The JAX package's compiled-dispatch contract in the port, on the CPU.

- ``make_dycore_stepper(..., donate, remat)`` against the JAX package's
  stepper with the same flags (C6 x 4 levels, float64, one tracer,
  non-zero phis), two chained dts;
- ``donate=False`` leaves the caller's state untouched, and the eager
  dt writes none of its inputs (what the capture's warm-up relies on);
- ``remat=True`` equals ``remat=False`` bit for bit forward, and the
  gradient of a scalar of one dt within 1e-12, and the JAX package's
  gradient through its one_dt built with remat=True within 1e-9;
- ``build_compiled_step`` with the solar constant as a 0-d tensor
  against the JAX ``full_step`` at two values of it (C6 x 8, the GFS
  suite with gray radiation, float64);
- no host read of a device value inside one dt or one coupled step: the
  step runs under a dispatch mode that raises on what a CUDA-graph
  capture refuses (``_local_scalar_dense``, ``is_nonzero``,
  ``nonzero``, ``equal``) and on a host array made into a tensor (on
  the card a copy from pageable memory);
- ``graphs.Graphed``'s checks and its argument trees.

The captured path itself needs the card: tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu import wrapper as jwrapper
from fv3net_tpu.dycore import hydro as jhydro
from fv3net_tpu.grid import CubedSphereGrid as JGrid
from fv3net_tpu.runtime.compiled_loop import build_compiled_step as j_build
from fv3net_tpu_torch import graphs
from fv3net_tpu_torch import wrapper as twrapper
from fv3net_tpu_torch.convert import state_from_numpy, state_to_numpy
from fv3net_tpu_torch.dycore import hydro as thydro
from fv3net_tpu_torch.grid import CubedSphereGrid as TGrid
from fv3net_tpu_torch.runtime import compiled_loop as tcl
from torch_parity import NoHostRead, assert_close_scaled, benchmark_like_state

torch.set_num_threads(1)

n, NZ, DT, PTOP = 6, 4, 900.0, 300.0
# tests/test_torch_dycore.py's parity tolerance: float64 through 6
# substeps and the remap, the operators agreeing to ~1e-15 each and w
# amplifying that to ~1e-11 of its magnitude
RTOL = 1e-9
# remat recomputes each substep's forward in the backward pass: the same
# operations on the same values, so the gradient can differ only where
# autograd sums the same terms in another order (~1e-16 a term)
GRAD_RTOL = 1e-12


def _numpy_state():
    delp, pt, u, v, q = benchmark_like_state(n, NZ, seed=0)
    st = jhydro.add_nonhydrostatic_fields(
        jhydro.DycoreState(*(jnp.asarray(a) for a in (delp, pt, u, v, q))),
        PTOP,
    )
    phis = 2000.0 * np.abs(np.random.RandomState(1).randn(6, n, n))
    return {k: np.asarray(x) for k, x in st._asdict().items()}, phis


def _kw(dtype):
    return dict(k_split=1, n_split=6, hord=5, kord=9, ptop=PTOP,
                dtype=dtype)


@pytest.fixture(scope="module")
def jax_two_dts():
    """Two chained dts of the JAX stepper built with donate=True and
    remat=True (the input of each call is donated: kept as numpy)."""
    state, phis = _numpy_state()
    run, _, _ = jhydro.make_dycore_stepper(
        JGrid.make(n, halo=3), NZ, DT, remat=True, donate=True,
        **_kw(jnp.float64),
    )
    st = jhydro.DycoreState(**{k: jnp.asarray(v) for k, v in state.items()})
    outs = []
    for _ in range(2):
        st = run(st, jnp.asarray(phis), 1)
        outs.append({k: np.asarray(x) for k, x in st._asdict().items()})
    return state, phis, outs


def _t_stepper(**flags):
    return thydro.make_dycore_stepper(
        TGrid.make(n, halo=3), NZ, DT, device="cpu",
        **_kw(torch.float64), **flags,
    )


@pytest.mark.parametrize("flags", [
    dict(donate=True), dict(remat=True), dict(donate=True, remat=True),
])
def test_stepper_flags_match_jax(jax_two_dts, flags):
    state, phis, want = jax_two_dts
    run, _, _ = _t_stepper(**flags)
    st = state_from_numpy(state, "cpu")
    ph = torch.as_tensor(phis)
    s1 = run(st, ph, 1)
    got = [state_to_numpy(s1), state_to_numpy(run(s1, ph, 1))]
    for step, (g, w) in enumerate(zip(got, want)):
        for k in w:
            assert_close_scaled(g[k], w[k], RTOL, name=f"dt {step} {k}")


def test_donate_false_leaves_input_unchanged(jax_two_dts):
    state, phis, _ = jax_two_dts
    run, _, _ = _t_stepper(donate=False)
    st = state_from_numpy(state, "cpu")
    ph = torch.as_tensor(phis)
    keep = [x.clone() for x in st] + [ph.clone()]
    out = run(st, ph, 2)
    for k, a, b in zip(list(st._fields) + ["phis"], list(st) + [ph], keep):
        assert torch.equal(a, b), k
    assert all(o.data_ptr() != i.data_ptr() for o, i in zip(out, st))


def _remat_pair():
    state, phis = _numpy_state()
    runs = [_t_stepper(remat=r)[0] for r in (False, True)]
    return state, torch.as_tensor(phis), runs


def test_every_kernel_wrapper_registers_its_counter():
    """The registry a replay moves (ops._build.COUNTED) holds each
    wrapper of K1-K8 and of the fused C-grid half-stage under its name,
    its counter an int."""
    from fv3net_tpu_torch import probe
    from fv3net_tpu_torch.ops import (
        _build, cuda_c_sw, cuda_column, cuda_filter, cuda_remap, cuda_sim1,
        cuda_tp,
    )

    assert _build.COUNTED == {
        "fv_tp_2d": cuda_tp.fv_tp_2d_cuda,
        "fv_tp_2d_multi5": cuda_tp.fv_tp_2d_multi5_cuda,
        "sim1_solver": cuda_sim1.sim1_solver_cuda,
        "del4_filter": cuda_filter.del4_filter_cuda,
        "del4_filter_pair": cuda_filter.del4_filter_pair_cuda,
        "column_pressures": cuda_column.column_pressures_cuda,
        "ppm_remap": cuda_remap.ppm_remap_cuda,
        "probe_affine": probe.affine_cuda,
        "probe_stencil": probe.stencil_cuda,
        "c_sw_half": cuda_c_sw.c_sw_half_cuda,
    }
    assert all(isinstance(w.launches, int) for w in _build.COUNTED.values())


def test_remat_forward_bit_for_bit():
    state, phis, runs = _remat_pair()
    outs = [run(state_from_numpy(state, "cpu"), phis, 1) for run in runs]
    for k, a, b in zip(outs[0]._fields, *outs):
        assert torch.equal(a, b), k


def _loss(out):
    return (out.w * out.delz).sum() + out.pt.sum()


def test_remat_gradient_of_one_dt():
    """d/d(u, pt) of sum(w * delz) + sum(pt) after one dt: the
    checkpointed substeps recompute in the backward pass.  remat=True
    against remat=False within GRAD_RTOL, and against ``jax.grad``
    through the JAX package's one_dt built with remat=True within the
    parity tolerance RTOL."""
    import jax

    state, phis, runs = _remat_pair()
    grads = []
    for run in runs:
        st = state_from_numpy(state, "cpu")
        u = st.u.clone().requires_grad_(True)
        pt = st.pt.clone().requires_grad_(True)
        out = run.one_dt(st._replace(u=u, pt=pt), phis)
        grads.append(torch.autograd.grad(_loss(out), (u, pt)))
    for name, a, b in zip(("u", "pt"), *grads):
        assert bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0
        assert_close_scaled(b.numpy(), a.numpy(), GRAD_RTOL, name=name)
    jrun, _, _ = jhydro.make_dycore_stepper(
        JGrid.make(n, halo=3), NZ, DT, remat=True, **_kw(jnp.float64))
    jst = jhydro.DycoreState(**{k: jnp.asarray(v) for k, v in state.items()})
    jphis = jnp.asarray(phis.numpy())
    want = jax.jit(jax.grad(
        lambda u, pt: _loss(jrun.one_dt(jst._replace(u=u, pt=pt), jphis)),
        argnums=(0, 1)))(jst.u, jst.pt)
    for name, got, w in zip(("u", "pt"), grads[1], want):
        assert_close_scaled(got.numpy(), np.asarray(w), RTOL,
                            name=f"{name} against JAX")


# --- the coupled step --------------------------------------------------------

CN, CNZ, CDT = 6, 8, 600.0


def _config(model_config):
    return model_config(
        npx=CN + 1, npz=CNZ, physics_suite="gfs", do_radiation=True,
        hydrostatic=False, dt_atmos=CDT, n_split=4, dtype="float64",
    )


def _coupled_inputs():
    """The JAX model's perturbed moist state and step inputs (numpy)."""
    jwrapper.initialize(_config(jwrapper.ModelConfig))
    mdl = jwrapper.get_model()
    rng = np.random.RandomState(0)
    mdl.state = mdl.state._replace(
        pt=mdl.state.pt + jnp.asarray(rng.randn(6, CNZ, CN, CN)),
        q=mdl.state.q.at[0].add(1e-3),
    )
    inputs = dict(
        state={k: None if x is None else np.asarray(x)
               for k, x in mdl.state._asdict().items()},
        phis=np.asarray(mdl.phis), tsfc=np.asarray(mdl.tsfc, np.float64),
        total_precip=np.asarray(mdl.total_precip, np.float64),
        cosz=np.clip(rng.rand(6, CN, CN) * 1.2 - 0.2, 0.0, None),
    )
    return mdl, inputs


@pytest.fixture(scope="module")
def coupled():
    """(port model, step inputs, JAX outputs at each solar constant)."""
    jmdl, inp = _coupled_inputs()
    jstep = j_build(jmdl)
    want = {}
    for solcon in SOLCONS:
        st = jhydro.DycoreState(**{
            k: None if v is None else jnp.asarray(v)
            for k, v in inp["state"].items()
        })
        out = jstep(st, jnp.asarray(inp["phis"]), jnp.asarray(inp["tsfc"]),
                    jnp.asarray(inp["total_precip"]),
                    jnp.asarray(inp["cosz"]), np.float64(solcon))
        want[solcon] = _outputs_numpy(out, np.asarray)
    twrapper.initialize(_config(twrapper.ModelConfig), device="cpu")
    return twrapper.get_model(), inp, want


SOLCONS = (1361.0, 1300.0)


def _outputs_numpy(out, as_numpy):
    st, tp, pr, diags = out
    res = {f"state.{k}": as_numpy(x) for k, x in st._asdict().items()
           if x is not None}
    res["total_precip"] = as_numpy(tp)
    res["precip_rate"] = as_numpy(pr)
    res.update({f"diag.{k}": as_numpy(v) for k, v in diags.items()})
    return res


def _port_inputs(inp):
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    return (state_from_numpy(inp["state"], "cpu"), t(inp["phis"]),
            t(inp["tsfc"]), t(inp["total_precip"]), t(inp["cosz"]))


@pytest.mark.parametrize("solcon", SOLCONS)
def test_compiled_step_solcon_tensor_matches_jax(coupled, solcon):
    mdl, inp, want = coupled
    step = tcl.build_compiled_step(mdl)
    out = step(*_port_inputs(inp), torch.tensor(solcon, dtype=torch.float64))
    got = _outputs_numpy(out, lambda x: x.numpy())
    assert set(got) == set(want[solcon])
    for k, w in want[solcon].items():
        assert_close_scaled(got[k], w, RTOL, name=k)
    # the solar constant reaches the result
    other = want[SOLCONS[1 - SOLCONS.index(solcon)]]
    key = "diag.total_sky_downward_shortwave_flux_at_surface"
    assert np.abs(other[key] - want[solcon][key]).max() > 0


# --- no host read inside a step ---------------------------------------------

def test_no_host_read_mode_catches_each_kind():
    x = torch.arange(4.0)
    for read in (lambda: float(x.sum()), lambda: bool(x.any()),
                 lambda: torch.nonzero(x), lambda: torch.equal(x, x),
                 lambda: x[x > 1.0],
                 lambda: torch.as_tensor(np.ones(3))):
        with pytest.raises(RuntimeError, match="host read"):
            with NoHostRead():
                read()
    with NoHostRead():  # a scalar set, masked fills, reductions pass
        y = x.clone()
        y[1] = 2.0
        y[y > 2.5] = 0.0
        y[torch.arange(0, 4, 2)] += 1.0
        torch.where(y > 1.0, y, 0.0).sum()


def test_no_host_read_in_one_dt():
    state, phis = _numpy_state()
    run, _, _ = _t_stepper()
    st = state_from_numpy(state, "cpu")
    ph = torch.as_tensor(phis)
    first = run.one_dt(st, ph)  # the warm-up: tables cached on first call
    with NoHostRead():
        again = run.one_dt(st, ph)
    for k, a, b in zip(first._fields, first, again):
        assert torch.equal(a, b), k


def test_no_host_read_in_one_coupled_step(coupled):
    mdl, inp, _ = coupled
    step = tcl.build_compiled_step(mdl)
    args = _port_inputs(inp) + (torch.tensor(1361.0, dtype=torch.float64),)
    first = step(*args)
    with NoHostRead():
        again = step(*args)
    a, b = (_outputs_numpy(o, lambda x: x) for o in (first, again))
    for k in a:
        assert torch.equal(a[k], b[k]), k


# --- graphs.Graphed ----------------------------------------------------------


def test_graphed_refuses_what_it_cannot_capture():
    g = graphs.Graphed(lambda x: x + 1, carry="all")
    with pytest.raises(ValueError, match="CUDA tensors"):
        g(torch.ones(3))
    with pytest.raises(ValueError, match="donate needs carry"):
        graphs.Graphed(lambda x: x, donate=True)
    with pytest.raises(ValueError, match="steps"):
        graphs.Graphed(lambda x: (x, x), carry=0)(torch.ones(2), steps=2)
    with pytest.raises(TypeError, match="cannot capture"):
        graphs._flatten((object(),))


def test_graphed_argument_trees_round_trip():
    st = thydro.DycoreState(torch.zeros(2), torch.ones(3), torch.ones(1),
                            torch.ones(1))
    tree = (st, {"a": torch.ones(2, 2), "b": [None, 3.5, torch.zeros(1)]},
            "x", 2)
    leaves, spec = graphs._flatten(tree)
    assert len(leaves) == 6
    back = graphs._build(spec, iter(leaves))
    assert type(back[0]) is thydro.DycoreState and back[0].q is None
    assert back[1]["b"][1] == 3.5 and back[2:] == ("x", 2)
    assert all(a is b for a, b in zip(graphs._flatten(back)[0], leaves))
    # the key tells shapes, dtypes, constants and structure apart
    other = (st._replace(q=torch.zeros(1)),) + tree[1:]
    assert graphs._flatten(other)[1] != spec
    assert graphs._flatten(tree[:3] + (3,))[1] != spec
    assert graphs._flatten((st._replace(delp=torch.zeros(2).double()),)
                           + tree[1:])[1] != spec


def test_graphed_adopts_only_dense_donated_buffers():
    """A donated field is written in place only where no two of its
    elements share memory and none is skipped, in any order of axes."""
    x = torch.ones(2, 3, 4)
    assert graphs._dense(x) and graphs._dense(x.permute(1, 0, 2))
    assert graphs._dense(torch.ones(1, 4)[:, :])
    assert not graphs._dense(torch.ones(3).expand(2, 3))
    assert not graphs._dense(x[:, :, :2])
