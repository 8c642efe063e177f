"""The coupled cell on the CPU, at C12 x 8 with the committed
configuration's scheme and limits (``tiny.tiny_root(config=
"C48x63-gfs-ml")``):

* a sound run is correct, and a traced run's line holds the cell's
  per-layer metrics: the six of its physics and corrector, read from
  the program's spans (a stand-in writer marks CPU tensors, as in
  tests/test_torch_tracing.py), and those it shares with the dycore
  cell;
* a run with the timed path broken underneath is not: the suite's deep
  convection left at the default Betts-Miller (the configuration's
  ``convection_scheme`` dropped on its way to the suite), the
  corrector's tendencies left out, and the microphysics' ice phases
  (ice, snow, graupel) dropped after each call;
* the control, the plain reference with its state held in bfloat16,
  fails the limits, and the program's own readings pass them;
* the readers find nothing, and raise nothing, on a program whose
  tracing has no coupled spans (a checkout before them).
"""

import io
import json
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import coupled_clocks, harness  # noqa: E402
from portbench.compare import judge  # noqa: E402
from portbench.tiny import read_result, tiny_root  # noqa: E402

CELL, CONFIG = "c48x63.coupled", "C48x63-gfs-ml"
METRICS = (
    "physics_ms_per_step", "radiation_ms_per_step", "pbl_ms_per_step",
    "convection_ms_per_step", "microphysics_ms_per_step",
    "corrector_ms_per_step",
)
# the dycore cell's metrics that read in this cell too, of those that
# read on the CPU (the kernels, the device's idle share, the exchanges'
# bytes and the capture read only on the card)
SHARED = (
    "host_ms_per_step", "step_mfu", "step_ms_p95", "c_sw_ms_per_step",
    "d_sw_ms_per_step", "riem_solver_ms_per_step", "damping_ms_per_step",
    "tracer_ms_per_step", "remap_ms_per_step", "stepper_build_s",
)


@pytest.fixture(autouse=True)
def open_at_once(monkeypatch):
    monkeypatch.setattr(harness, "OPEN_AT_S", 0.0)


def _write(log, mark_id):
    """What the card's mark kernel does, on a CPU log."""
    cap = log.shape[0] - 1
    c = int(log[0, 0])
    log[1 + c % cap, 0] = mark_id
    log[1 + c % cap, 1] = time.perf_counter_ns()
    log[0, 0] = c + 1


@pytest.fixture
def marks(monkeypatch):
    from fv3net_tpu_torch import tracing

    monkeypatch.setitem(tracing.WRITERS, "cpu", _write)
    monkeypatch.setattr(tracing, "_log", None)
    monkeypatch.setattr(tracing, "_decoded", None)
    monkeypatch.setattr(tracing, "HOST", tracing.Timer())
    return tracing


def run_cell(root, *args, seed=2147483713):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", CELL, "--seed", str(seed),
                       "--seconds", "0.01", *args], root=root,
                      device="cpu", out=out, err=err)
    assert rc == 0, err.getvalue()
    return read_result(out.getvalue()), err.getvalue()


def test_sound_run_is_correct_and_traced(tmp_path, marks, capsys):
    root = tiny_root(tmp_path, CONFIG)
    res, _ = run_cell(root, "--trace", "0")
    err = capsys.readouterr().err
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"sdpd", "setup_s"}
    assert len(res["checks"]) == 33
    assert all(v["limit"] is not None for v in res["checks"].values())
    assert "dropped 0 entries" in err and "SAS fired in" in err

    res, _ = run_cell(root, "--trace", "1")
    assert res["correct"] is True, res["checks"]
    assert set(METRICS) <= set(res["metrics"])
    for k in METRICS + SHARED:
        assert res["metrics"][k]["value"] > 0.0, k
    # the stages lie inside the step, the suite's parts inside physics
    m = {k: v["value"] for k, v in res["metrics"].items()}
    parts = ("radiation_ms_per_step", "pbl_ms_per_step",
             "convection_ms_per_step", "microphysics_ms_per_step")
    assert sum(m[k] for k in parts) < m["physics_ms_per_step"]


def _betts_miller(monkeypatch):
    from fv3net_tpu_torch.physics import gfs

    real = gfs.GFSPhysicsConfig

    def dropped(**kw):
        kw.pop("convection_scheme", None)
        return real(**kw)

    monkeypatch.setattr(gfs, "GFSPhysicsConfig", dropped)


def _no_corrector(monkeypatch):
    from fv3net_tpu_torch.runtime import compiled_loop

    monkeypatch.setattr(
        compiled_loop, "non_negative_sphum",
        lambda qv, dQ1, dQ2, dt: (torch.zeros_like(dQ1),
                                  torch.zeros_like(dQ2)))


def _no_ice_phases(monkeypatch):
    from fv3net_tpu_torch.physics import gfdl_mp

    real = gfdl_mp.gfdl_cloud_microphysics

    def dropped(*args, **kw):
        state, diags = real(*args, **kw)
        for k in ("cloud_ice_mixing_ratio", "snow_mixing_ratio",
                  "graupel_mixing_ratio"):
            state[k] = torch.zeros_like(state[k])
        return state, diags

    monkeypatch.setattr(gfdl_mp, "gfdl_cloud_microphysics", dropped)


@pytest.mark.parametrize("fault", [_betts_miller, _no_corrector,
                                   _no_ice_phases])
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    res, _ = run_cell(tiny_root(tmp_path, CONFIG))
    assert res["correct"] is False, res["checks"]


def test_control_fails_the_limits(tmp_path):
    from portbench.control_coupled import control_readings

    root = tiny_root(tmp_path, CONFIG)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    file = next(c["file"] for c in bench["configs"] if c["name"] == CONFIG)
    cfg = json.loads((root / file).read_text())
    traffic = json.loads(
        (root / "portbench/traffic/coupled.json").read_text())
    rows = control_readings(cfg, traffic, [1, 2147483661], 3,
                            torch.device("cpu"))
    for _, program, control, _ in rows:
        assert judge(program, cfg["limits"]), program
        assert not judge(control, cfg["limits"]), control


def test_readers_find_nothing_before_the_coupled_spans(monkeypatch,
                                                       marks):
    monkeypatch.setattr(marks, "SPANS", marks.SPANS[:10])
    assert coupled_clocks.step_ms("step.physics") is None
    monkeypatch.setitem(sys.modules, "fv3net_tpu_torch.tracing", None)
    assert coupled_clocks.step_ms("step.physics") is None
