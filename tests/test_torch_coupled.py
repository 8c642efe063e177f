"""The coupled slice as a whole: two coupled steps of the port's
CompiledTimeLoop (nonhydrostatic dycore + gray radiation + GFS physics +
a dense ML corrector) against the JAX package's, at the C6 x 8 float64
configuration of tests/test_compiled_loop.py, with the same JAX-trained
dense model loaded from its dump in both packages."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv3net_tpu import fit as jfit
from fv3net_tpu import wrapper as jwrapper
from fv3net_tpu.data import SyntheticWaves
from fv3net_tpu.runtime.compiled_loop import CompiledTimeLoop as JLoop
from fv3net_tpu_torch import fit as tfit
from fv3net_tpu_torch import wrapper as twrapper
from fv3net_tpu_torch.runtime import compiled_loop as tcl
from torch_parity import assert_close_scaled

torch.set_num_threads(1)

N, NZ, DT = 6, 8, 600.0
FIELDS = ("delp", "pt", "u", "v", "q", "w", "delz", "total_precip")
# Tolerances, relative to each field's magnitude.  Everything outside the
# MLP runs in float64 in both packages and agrees to roundoff amplified
# by the dycore (measured <= 6e-12 over a step, w the worst): RTOL.
RTOL = 1e-9
# The MLP runs in float32 in both packages and their matmuls sum in other
# orders: dQ1/dQ2 differ by ~1e-7 of themselves, and this model's
# dQ2 * dt is of the size of q itself, so a field the corrector has
# reached differs by up to ~5e-8 of its magnitude (measured: q 4.5e-8
# after one step; every field after two): RTOL_ML.
RTOL_ML = 1e-6
# fields the corrector has reached after the first step (postphysics
# sets delp, pt and q); the dycore spreads it to all after the second
REACHED_BY_ML = ("delp", "pt", "q")


def _config(model_config):
    return model_config(
        npx=N + 1, npz=NZ, physics_suite="gfs", do_radiation=True,
        hydrostatic=False, dt_atmos=DT, n_split=4, dtype="float64",
    )


def _perturbation():
    return np.random.RandomState(0).randn(6, NZ, N, N)


def _init_jax():
    jwrapper.initialize(_config(jwrapper.ModelConfig))
    mdl = jwrapper.get_model()
    mdl.state = mdl.state._replace(
        pt=mdl.state.pt + jnp.asarray(_perturbation()),
        q=mdl.state.q.at[0].add(1e-3),
    )
    return mdl


def _init_torch():
    twrapper.initialize(_config(twrapper.ModelConfig), device="cpu")
    mdl = twrapper.get_model()
    q = mdl.state.q.clone()
    q[0] += 1e-3
    mdl.state = mdl.state._replace(
        pt=mdl.state.pt + torch.as_tensor(_perturbation()), q=q,
    )
    return mdl


@pytest.fixture(scope="module")
def dense_dir(tmp_path_factory):
    """A JAX-trained dense model (tests/test_compiled_loop.py's), its
    outputs scaled to physical tendency sizes, dumped in the JAX
    package's format."""
    batches = SyntheticWaves(
        ["air_temperature", "specific_humidity", "dQ1", "dQ2"],
        n=N, nz=NZ, nbatch=1, seed=0,
    ).batches()
    model = jfit.train_dense_model(
        jfit.DenseHyperparameters(depth=1, width=8, epochs=1),
        batches,
        input_variables=["air_temperature", "specific_humidity"],
        output_variables=["dQ1", "dQ2"],
    )
    model.scaler_out.mean = model.scaler_out.mean * 1e-9
    model.scaler_out.std = model.scaler_out.std * 1e-9
    path = str(tmp_path_factory.mktemp("dense"))
    jfit.dump(model, path)
    return path


def _snapshot(mdl, as_numpy):
    out = {k: as_numpy(getattr(mdl.state, k)) for k in FIELDS[:-1]}
    out["total_precip"] = as_numpy(mdl.total_precip)
    return out


@pytest.fixture(scope="module")
def two_steps(dense_dir):
    """Two coupled steps in each package from the same initial state:
    (jax, torch) lists of (state fields + total_precip, diagnostics),
    one per step."""
    mdl = _init_jax()
    jsteps = [
        (_snapshot(mdl, np.asarray), d)
        for _, d in JLoop(jwrapper, ml_model=jfit.load(dense_dir), n_steps=2)
    ]
    jtime = mdl.time

    tm = _init_torch()
    loop = tcl.CompiledTimeLoop(
        twrapper, ml_model=tfit.load(dense_dir, "cpu"), n_steps=2
    )
    tsteps = [(_snapshot(tm, lambda x: x.numpy()), d) for _, d in loop]
    assert tm.time == jtime
    return jsteps, tsteps


@pytest.mark.parametrize("field", FIELDS)
def test_first_coupled_step_matches_jax(two_steps, field):
    (jout, _), (tout, _) = two_steps[0][0], two_steps[1][0]
    rtol = RTOL_ML if field in REACHED_BY_ML else RTOL
    assert_close_scaled(tout[field], jout[field], rtol, name=field)


@pytest.mark.parametrize("field", FIELDS)
def test_second_coupled_step_matches_jax(two_steps, field):
    (jout, _), (tout, _) = two_steps[0][1], two_steps[1][1]
    assert_close_scaled(tout[field], jout[field], RTOL_ML, name=field)


@pytest.mark.parametrize("key", [
    "water_vapor_path",
    "tendency_of_air_temperature_due_to_fv3_dynamics",
    "tendency_of_specific_humidity_due_to_fv3_dynamics",
    "tendency_of_air_temperature_due_to_fv3_physics",
    "storage_of_mass_due_to_fv3_physics",
    "shortwave_heating_rate",
    "longwave_heating_rate",
    "total_sky_downward_longwave_flux_at_surface",
    "sensible_heat_flux",
    "latent_heat_flux",
    "planetary_boundary_layer_height",
    "shallow_convection_active",
    "convective_precipitation",
    "large_scale_precipitation",
    "tendency_of_air_temperature_due_to_python",
    "tendency_of_specific_humidity_due_to_python",
    "storage_of_mass_due_to_python",
    "dQ1_filled_frac",
    "dQ2_filled_frac",
])
def test_coupled_diagnostics_match_jax(two_steps, key):
    """Diagnostics of the first step: everything up to the corrector
    runs on an ML-free state (RTOL); the tendencies due to the corrector
    ("python") pass through the float32 MLP, where ~1e-7 of themselves
    is roundoff (1e-5)."""
    (_, jd), (_, td) = two_steps[0][0], two_steps[1][0]
    rtol = 1e-5 if key.endswith("due_to_python") else RTOL
    assert_close_scaled(td[key].values, np.asarray(jd[key].data), rtol,
                        name=key)


def test_split_stages_compose_to_fused(dense_dir):
    """The three stage functions, run in turn, give the fused step bit
    for bit, and their diagnostics together are the fused step's."""
    model = tfit.load(dense_dir, "cpu")
    mdl = _init_torch()
    fused, stages = tcl.build_compiled_step(mdl, model, split=True)
    tsfc = torch.as_tensor(mdl.tsfc)
    tp0 = torch.as_tensor(mdl.total_precip)
    cosz = torch.full((6, N, N), 0.3, dtype=torch.float64)
    st1, d1 = stages["dynamics"](mdl.state, mdl.phis)
    st2, tp, pr, d2 = stages["physics"](st1, tsfc, tp0, cosz, 1361.0)
    st3, d3 = stages["postphysics"](st2)
    stf, tpf, prf, df = fused(mdl.state, mdl.phis, tsfc, tp0, cosz, 1361.0)
    for k in FIELDS[:-1]:
        assert torch.equal(getattr(st3, k), getattr(stf, k)), k
    assert torch.equal(tp, tpf) and torch.equal(pr, prf)
    assert set(df) == set(d1) | set(d2) | set(d3)


@pytest.mark.parametrize("suite", ["simple", "none", "gfs_gfdl"])
def test_physics_stage_of_other_suites_matches_jax(suite):
    """The compiled step's "simple" (saturation adjustment) and "none"
    physics branches, and the GFS suite with GFDL microphysics over six
    advected species: the JAX package's physics stage and the port's on
    the same moist, perturbed state."""
    from fv3net_tpu.runtime.compiled_loop import build_compiled_step

    kw = dict(npx=N + 1, npz=NZ, physics_suite=suite, hydrostatic=False,
              dt_atmos=DT, n_split=4, dtype="float64")
    if suite == "gfs_gfdl":
        kw.update(physics_suite="gfs", microphysics_scheme="gfdl",
                  prognostic_mp_tracers=True, do_radiation=False)
    jwrapper.initialize(jwrapper.ModelConfig(**kw))
    jm = jwrapper.get_model()
    twrapper.initialize(twrapper.ModelConfig(**kw), device="cpu")
    tm = twrapper.get_model()
    rng = np.random.RandomState(5)
    pt = np.asarray(jm.state.pt) + rng.randn(6, NZ, N, N)
    q = np.asarray(jm.state.q).copy()
    q[0] = 2e-2 * rng.rand(6, NZ, N, N)  # supersaturated in places
    q[1] = 1e-4 * rng.rand(6, NZ, N, N)
    q[2:] = 1e-4 * rng.rand(*q[2:].shape)  # the GFDL hydrometeors
    _, jstages = build_compiled_step(jm, None, split=True)
    _, tstages = tcl.build_compiled_step(tm, None, split=True)
    tsfc, tp0 = np.asarray(jm.tsfc), np.zeros((6, N, N))
    cosz = np.full((6, N, N), 0.3)
    jst, jtp, jpr, jd = jstages["physics"](
        jm.state._replace(pt=jnp.asarray(pt), q=jnp.asarray(q)),
        jnp.asarray(tsfc), jnp.asarray(tp0), jnp.asarray(cosz),
        jnp.asarray(1361.0),
    )
    tst, ttp, tpr, td = tstages["physics"](
        tm.state._replace(pt=torch.as_tensor(pt), q=torch.as_tensor(q)),
        torch.as_tensor(tsfc), torch.as_tensor(tp0), torch.as_tensor(cosz),
        1361.0,
    )
    assert set(td) == set(jd)
    for k in ("delp", "pt", "q"):
        assert_close_scaled(getattr(tst, k).numpy(),
                            np.asarray(getattr(jst, k)), RTOL, name=k)
    for name, got, want in (("total_precip", ttp, jtp),
                            ("precip_rate", tpr, jpr)):
        assert_close_scaled(got.numpy(), np.asarray(want), RTOL, name=name)
    if suite in ("simple", "gfs_gfdl"):
        assert (np.asarray(jpr) > 0).any()  # the physics rained


@pytest.mark.parametrize("output", ["dQu", "dQv", "dQx_wind", "dQp"])
def test_dropped_tendency_outputs_raise_at_build(dense_dir, output):
    """The JAX package fills and then drops wind and delp tendencies;
    the port refuses a model with such outputs when the step is built."""
    model = copy.copy(tfit.load(dense_dir, "cpu"))
    model.output_variables = ["dQ1", output]
    with pytest.raises(NotImplementedError, match=output):
        tcl.build_compiled_step(_init_torch(), model)
