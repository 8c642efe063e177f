"""fv3net's ML-corrected coupled configuration (the benchmark's
``C48x63-gfs-ml``) on the CPU:

- the port's coupled step (``wrapper.initialize`` with the
  configuration's ``ModelConfig``, ``fit.load``, ``CompiledTimeLoop``)
  against the plain reference's (``portbench/reference/coupled.py``),
  eager at C12 x 8 in float64 and in float32, two steps from the
  benchmark's seeded state and corrector; the reference with its state
  held in bfloat16 fails the same tolerances (in every number but those
  of the rain and graupel left in the air, next to none on both sides);
- the reference imports nothing of the port, of the JAX package or of
  JAX;
- ``ModelConfig.convection_scheme`` reaches the suite's configuration,
  and the compiled step with SAS and prognostic GFDL microphysics equals
  the JAX package's ``build_compiled_step`` with the JAX model's
  ``gfs_config`` given the same scheme (float64, C6 x 8, beside
  tests/test_torch_coupled.py's steps).
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from fv3net_tpu import wrapper as jwrapper  # noqa: E402
from fv3net_tpu.runtime.compiled_loop import (  # noqa: E402
    build_compiled_step as j_build,
)
from fv3net_tpu_torch import fit, wrapper  # noqa: E402
from fv3net_tpu_torch.runtime import compiled_loop as tcl  # noqa: E402
from portbench.entries import coupled as entry  # noqa: E402
from torch_parity import assert_close_scaled  # noqa: E402

torch.set_num_threads(1)

SEED = 2147483713
CPU = torch.device("cpu")
# the gap of each compared number, ||port - reference|| / ||reference||
# over the field (the cell's ``norm_gap``), after each of two steps.  The
# port's eager step runs the reference's operations in the same order,
# so the two agree to the last digit (measured: 0 in every number, in
# float64 and in float32, on one thread).  float64: 1e-12 leaves room
# for a reduction summed in another order.  float32: 1e-5 leaves room
# for torch's threaded reductions summing in another order, carried
# through the dycore (measured on two threads: up to 6e-7, in the
# winds).  The reference with its state held in bfloat16, the precision
# below the configuration's float32, reads 1.2e-3 and more in every
# number but those of rain and graupel (next to none on both sides) and
# fails both by a factor of ten at least.
TOLERANCE = {torch.float64: 1e-12, torch.float32: 1e-5}
NUMBERS = tuple(f"{w}_{k}" for w in ("first", "later") for k in (
    "delp", "pt", "u", "v", "w", "delz", "precip") + entry.TRACERS
    if (w, k) != ("later", "qs")) + ("first_dQ1", "first_dQ2")


def _config(dtype):
    cfg = json.loads((ROOT / "portbench/configs/C48x63-gfs-ml.json")
                     .read_text())
    cfg.update(resolution=12, nz=8,
               dtype="float64" if dtype == torch.float64 else "float32")
    return cfg


def _traffic():
    return json.loads((ROOT / "portbench/traffic/coupled.json").read_text())


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The benchmark's corrector at 8 levels (depth 3, width 64), written
    from the seed and the seed's state as a run writes it."""
    cfg = _config(torch.float64)
    st, _ = entry.initial_state(cfg, _traffic(), SEED, CPU, torch.float64)
    return entry.write_corrector(str(tmp_path_factory.mktemp("dense")), cfg,
                                 st, SEED)


def _port_steps(cfg, dtype, artifact, steps=2):
    """[(input state, total_precip, time), what ``entry.compared``
    takes] of `steps` port steps from the seed's state."""
    from fv3net_tpu_torch.dycore.hydro import DycoreState

    wrapper.initialize(wrapper.ModelConfig(**entry.model_config(cfg)),
                       device="cpu")
    mdl = wrapper.get_model()
    st, tsfc = entry.initial_state(cfg, _traffic(), SEED, CPU, dtype)
    mdl.state = DycoreState(*(t.clone() for t in st))
    mdl.tsfc = tsfc
    mdl.total_precip = torch.zeros_like(tsfc)
    loop = tcl.CompiledTimeLoop(wrapper, fit.load(artifact, "cpu"))
    out = []
    for _ in range(steps):
        x = (DycoreState(*(t.clone() for t in mdl.state)),
             mdl.total_precip.clone(), mdl.time)
        diags = loop.step()
        got = {"state": DycoreState(*(t.clone() for t in mdl.state)),
               "precip": mdl.precip_rate.clone()}
        got.update({k: diags[name].data
                    for k, name in entry.TENDENCIES.items()})
        out.append((x, got))
    return out, tsfc


def _readings(pairs, tsfc, step):
    res = {}
    for i, ((st, tp, t), got) in enumerate(pairs):
        want = entry.reference_outputs(step(st, tsfc, tp, t))
        res.update(entry.compared(("first", "later")[i], got, want))
    return res


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_port_step_matches_the_reference(artifact, dtype):
    from portbench.control_coupled import bf16_state

    cfg = _config(dtype)
    pairs, tsfc = _port_steps(cfg, dtype, artifact)
    step = entry.reference_step(cfg, artifact, dtype, CPU)
    got = _readings(pairs, tsfc, step)
    assert set(got) == set(NUMBERS)
    tol = TOLERANCE[dtype]
    assert all(v <= tol for v in got.values()), got
    # the suite ran: it rained, the corrector moved the state
    for _, out in pairs:
        assert float(out["precip"].abs().max()) > 0.0
        assert float(out["dQ1"].abs().max()) > 0.0
    # the bfloat16 control fails the tolerance in every number but those
    # of rain and graupel: at dt 900 s they fall through each layer within
    # the step (6 and 4 m/s x 900 s are more than any layer's depth here),
    # so no rain and next to no graupel (a millionth of the condensate or
    # less) stays in the air on either side
    control = _readings(pairs, tsfc, bf16_state(step))
    for _, out in pairs:
        assert float(out["state"].q[3].abs().max()) == 0.0
    assert control["first_qr"] == control["later_qr"] == 0.0
    fallen = {f"{w}_{k}" for w in ("first", "later") for k in ("qr", "qg")}
    assert all(v > 10 * tol for k, v in control.items()
               if k not in fallen), control


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.reference.coupled, portbench.reference.physics\n"
        "print(sorted({k.split('.')[0] for k in sys.modules}))\n"
    ) % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout
    tops = set(eval(out.strip().splitlines()[-1]))
    assert not tops & {"fv3net_tpu_torch", "fv3net_tpu", "jax", "jaxlib",
                       "flax"}
    assert "torch" in tops


def test_convection_scheme_reaches_the_suite():
    kw = dict(npx=7, npz=8, physics_suite="gfs")
    wrapper.initialize(wrapper.ModelConfig(**kw), device="cpu")
    assert wrapper.get_model().gfs_config.convection_scheme == "betts_miller"
    wrapper.initialize(wrapper.ModelConfig(
        convection_scheme="mass_flux", **kw), device="cpu")
    assert wrapper.get_model().gfs_config.convection_scheme == "mass_flux"


N, NZ, DT = 6, 8, 600.0
RTOL = 1e-9  # float64 in both packages (tests/test_torch_coupled.py)


def test_mass_flux_compiled_step_matches_jax():
    """The compiled step of the GFS suite with SAS and the four GFDL
    hydrometeors prognostic, gray radiation, nonhydrostatic: the JAX
    package's (its ``gfs_config`` given ``convection_scheme="mass_flux"``,
    which its ModelConfig cannot select) and the port's (through
    ``ModelConfig``), at the benchmark's hord and ptop, on the
    benchmark's seeded state, in float64.  At kord 9: at the benchmark's
    kord 10 the two packages' dycore stages alone differ by up to 9e-7 of
    pt's magnitude on this state (measured; their physics stages, given
    one input, agree to 1e-15), more than RTOL."""
    kw = dict(npx=N + 1, npz=NZ, physics_suite="gfs",
              microphysics_scheme="gfdl", prognostic_mp_tracers=True,
              do_radiation=True, hydrostatic=False, dt_atmos=DT, n_split=4,
              hord=6, kord=9, ptop=64.247, dtype="float64")
    jwrapper.initialize(jwrapper.ModelConfig(**kw))
    jm = jwrapper.get_model()
    jm.gfs_config = dataclasses.replace(jm.gfs_config,
                                        convection_scheme="mass_flux")
    wrapper.initialize(wrapper.ModelConfig(convection_scheme="mass_flux",
                                           **kw), device="cpu")
    tm = wrapper.get_model()
    assert (dataclasses.asdict(tm.gfs_config)
            == dataclasses.asdict(jm.gfs_config))
    # the benchmark's seeded state at C6 x 8: SAS fires in some columns
    cfg = dict(_config(torch.float64), resolution=N, nz=NZ)
    st, tsfc = entry.initial_state(cfg, _traffic(), SEED, CPU,
                                   torch.float64)
    st = {k: getattr(st, k).numpy() for k in ("delp", "pt", "u", "v", "q",
                                              "w", "delz")}
    tsfc = tsfc.numpy()
    tp0 = np.zeros((6, N, N))
    cosz = np.clip(np.random.RandomState(11).rand(6, N, N) * 1.2 - 0.2,
                   0.0, None)
    jout = j_build(jm)(
        jm.state._replace(**{k: jnp.asarray(v) for k, v in st.items()}),
        jnp.asarray(jm.phis), jnp.asarray(tsfc), jnp.asarray(tp0),
        jnp.asarray(cosz), np.float64(1361.0))
    tout = tcl.build_compiled_step(tm)(
        tm.state._replace(**{k: torch.as_tensor(v) for k, v in st.items()}),
        tm.phis, torch.as_tensor(tsfc), torch.as_tensor(tp0),
        torch.as_tensor(cosz), torch.tensor(1361.0, dtype=torch.float64))
    jst, jtp, jpr, jd = jout
    tst, ttp, tpr, td = tout
    assert set(td) == set(jd)
    for f in ("delp", "pt", "u", "v", "q", "w", "delz"):
        assert_close_scaled(getattr(tst, f).numpy(),
                            np.asarray(getattr(jst, f)), RTOL, name=f)
    for name, got, want in (("total_precip", ttp, jtp),
                            ("precip_rate", tpr, jpr)):
        assert_close_scaled(got.numpy(), np.asarray(want), RTOL, name=name)
    for key in ("convective_precipitation", "large_scale_precipitation",
                "shallow_convection_active"):
        assert_close_scaled(td[key].numpy(), np.asarray(jd[key]), RTOL,
                            name=key)
    # SAS rained in some columns
    assert (np.asarray(jd["convective_precipitation"]) > 0).any()
