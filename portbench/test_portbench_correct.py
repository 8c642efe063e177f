"""What decides ``correct``, at a size a test run holds (C12 x 8 on the
CPU, the committed configurations' limits):

* a sound run of the program is correct;
* a run with the timed path broken underneath is not, for each fault a
  dycore cell can have: a dt that returns its state unchanged, half of
  the cube (three faces) left out of the dt, and an answer altered where
  it is produced (one point of one field);
* the control, the plain reference with its state held in bfloat16, the
  precision below the configurations' float32, fails the limits.
"""

import io
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import harness  # noqa: E402
from portbench.compare import judge  # noqa: E402
from portbench.tiny import read_result, tiny_root  # noqa: E402

CONFIGS = {"c48x63.dycore": "C48x63"}


@pytest.fixture(autouse=True)
def open_at_once(monkeypatch):
    monkeypatch.setattr(harness, "OPEN_AT_S", 0.0)


def run_cell(root, cell, seed=2147483713):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", "0.01"], root=root, device="cpu",
                      out=out, err=err)
    assert rc == 0, err.getvalue()
    return read_result(out.getvalue())


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("cell", sorted(CONFIGS))
def test_sound_run_is_correct(tmp_path, cell, donate):
    res = run_cell(tiny_root(tmp_path, CONFIGS[cell], donate=donate), cell)
    assert res["correct"] is True, res["checks"]
    assert all(v["limit"] is not None for v in res["checks"].values())


def _unchanged(state, out):
    return state


def _half_left_out(state, out):
    return type(out)(*(
        None if o is None else torch.cat([o[..., :3, :, :, :], s[..., 3:, :, :, :]], -4)
        for s, o in zip(state, out)))


def _altered(state, out):
    pt = out.pt.clone()
    change = float((out.pt - state.pt).abs().max())
    pt[0, 0, 0, 0] += 0.5 * change
    return out._replace(pt=pt)


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _altered])
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    from fv3net_tpu_torch.dycore import hydro

    real = hydro.make_dycore_stepper

    def broken(*args, **kwargs):
        run, m, coef = real(*args, **kwargs)

        def run_broken(state, phis, nsteps):
            for _ in range(nsteps):
                state = fault(state, run(state, phis, 1))
            return state

        return run_broken, m, coef

    monkeypatch.setattr(hydro, "make_dycore_stepper", broken)
    res = run_cell(tiny_root(tmp_path), "c48x63.dycore")
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", sorted(CONFIGS))
def test_control_fails_the_limits(tmp_path, cell):
    import json

    from portbench.control import control_readings

    root = tiny_root(tmp_path, CONFIGS[cell])
    bench = json.loads((root / "BENCHMARK.json").read_text())
    file = next(c["file"] for c in bench["configs"]
                if c["name"] == CONFIGS[cell])
    cfg = json.loads((root / file).read_text())
    traffic = json.loads((root / "portbench/traffic/dycore.json").read_text())
    rows = control_readings(cfg, traffic, [1, 2, 2147483661], 3,
                            torch.device("cpu"))
    for _, program, control, _ in rows:
        assert judge(program, cfg["limits"])
        assert not judge(control, cfg["limits"]), control
