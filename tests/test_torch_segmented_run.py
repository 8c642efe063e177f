"""The port's segmented run (create / append / resume) and its ``runfv3``
CLI (run-native, parse-logs) on the CPU, as tests/test_segmented_run.py
drives the JAX package's, and the port's RESTART stores, diagnostics and
scalars against the JAX package's run of the same configuration (C6 x 6,
hydrostatic, simple suite, float64) from the same seeded RESTART; the
restart round trip in float32."""

import datetime
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from fv3net_tpu import wrapper as jwrapper
from fv3net_tpu.io.zarr_lite import ZarrLiteStore as JStore
from fv3net_tpu.runtime import segmented_run as jrun
from fv3net_tpu_torch import wrapper as twrapper
from fv3net_tpu_torch.io.zarr_lite import ZarrLiteStore
from fv3net_tpu_torch.runtime import segmented_run as trun
from fv3net_tpu_torch.runtime.cli import main
from fv3net_tpu_torch.runtime.timing import read_scalars
from torch_parity import assert_close_scaled

torch.set_num_threads(1)

CONFIG = {
    "namelist": {
        "npx": 7,
        "npz": 6,
        "dt_atmos": 600.0,
        "n_split": 4,
        "segment_steps": 2,
        "dtype": "float64",
    },
    "diagnostics": [
        {
            "name": "diags.zarr",
            "variables": ["water_vapor_path"],
            "times": {"kind": "every"},
        }
    ],
}
# float64 in both packages, two segments of two hydrostatic steps of the
# simple suite: every RESTART field, water_vapor_path and scalar agrees
# to <= 2.2e-13 of its magnitude (measured; the worst is cloud water,
# water_vapor_path is equal), so 1e-11
RTOL = 1e-11


@pytest.fixture(scope="module")
def runs(tmp_path_factory, monkeypatch_module):
    """create + two appends of CONFIG in each package: {pkg: url}.  The
    JAX package's two appends build the same dycore twice; they share
    one jitted step instead of compiling it twice."""
    from fv3net_tpu.dycore import hydro as jhydro

    built = {}

    def cached(*args, **kwargs):
        key = repr((args[1:], sorted(kwargs.items())))
        if key not in built:
            built[key] = jhydro.make_dycore_stepper(*args, **kwargs)
        return built[key]

    monkeypatch_module.setattr(jwrapper, "make_dycore_stepper", cached)
    seed = str(tmp_path_factory.mktemp("seed") / "RESTART")
    _seeded_restart(seed)
    urls = {}
    for pkg, mod, kw in (("jax", jrun, {}), ("torch", trun,
                                             {"device": "cpu"})):
        url = urls[pkg] = str(tmp_path_factory.mktemp(pkg) / "run")
        mod.create(url, CONFIG)
        shutil.copytree(seed, os.path.join(url, "artifacts", "0000",
                                           "RESTART"))
        assert mod.append(url, **kw) == 0
        assert mod.append(url, **kw) == 0
    return urls


def _seeded_restart(path):
    """Segment 0000's RESTART, which both packages resume from: the
    initial state of CONFIG with seeded temperature noise, winds of a
    few m/s, humidity up to 10% supersaturated (so that the simple suite
    rains) and a perturbed surface temperature."""
    nl = CONFIG["namelist"]
    twrapper.initialize(twrapper.ModelConfig(
        npx=nl["npx"], npz=nl["npz"], dt_atmos=nl["dt_atmos"],
        n_split=nl["n_split"], dtype=nl["dtype"]), device="cpu")
    rng = np.random.RandomState(11)
    st = twrapper.get_state(trun.RESTART_NAMES)
    t = st["air_temperature"].values + rng.randn(*st["air_temperature"].shape)
    p = np.cumsum(st["pressure_thickness_of_atmospheric_layer"].values,
                  axis=1) + 300.0
    es = 611.2 * np.exp(17.67 * (t - 273.15) / (t - 29.65))
    rh = rng.uniform(0.5, 1.1, size=(6, 1) + t.shape[2:])
    new = {
        "air_temperature": t,
        "specific_humidity": np.minimum(
            rh * 0.622 * es / (p - 0.378 * es), 0.02),
        "x_wind": 5.0 * rng.randn(*st["x_wind"].shape),
        "y_wind": 5.0 * rng.randn(*st["y_wind"].shape),
        "surface_temperature": 288.0 + rng.randn(
            *st["surface_temperature"].shape),
    }
    twrapper.set_state({k: st[k].with_data(v) for k, v in new.items()})
    trun.write_restart(twrapper, path)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


SEGMENTS = ("0001", "0002")  # after the seeded 0000


def test_create_append_resume(runs):
    url = runs["torch"]
    assert os.path.exists(os.path.join(url, "fv3config.yml"))
    for seg in SEGMENTS:
        d = os.path.join(url, "artifacts", seg)
        for name in ("RESTART", "diags.zarr", "scalars.jsonl",
                     "timing.json"):
            assert os.path.exists(os.path.join(d, name)), (seg, name)
    # time advanced by 2 segments x 2 steps x 600 s
    t0 = datetime.datetime.fromisoformat(twrapper.ModelConfig().initial_time)
    assert (twrapper.get_model().time - t0).total_seconds() == 4 * 600.0
    with open(os.path.join(url, "artifacts", SEGMENTS[-1], "RESTART",
                           "time.json")) as f:
        t = datetime.datetime.fromisoformat(json.load(f)["time"])
    assert (t - t0).total_seconds() == 4 * 600.0
    store = ZarrLiteStore(os.path.join(url, "artifacts", SEGMENTS[-1],
                                       "diags.zarr"))
    wvp = store.read("water_vapor_path")
    assert wvp.shape == (2, 6, 6, 6)
    assert np.isfinite(wvp).all()
    with open(os.path.join(url, "artifacts", SEGMENTS[0],
                           "timing.json")) as f:
        timing = json.load(f)
    assert timing["mainloop"]["count"] == 2
    assert twrapper.get_model().state.delp.device.type == "cpu"


@pytest.mark.parametrize("seg", SEGMENTS)
@pytest.mark.parametrize("name", trun.RESTART_NAMES)
def test_restart_matches_jax(runs, seg, name):
    got = ZarrLiteStore(os.path.join(runs["torch"], "artifacts", seg,
                                     "RESTART"))
    want = JStore(os.path.join(runs["jax"], "artifacts", seg, "RESTART"))
    assert got.attrs(name) == want.attrs(name)
    assert_close_scaled(got.read(name), want.read(name), RTOL, name=name)


@pytest.mark.parametrize("seg", SEGMENTS)
def test_diagnostics_and_scalars_match_jax(runs, seg):
    d = {pkg: os.path.join(url, "artifacts", seg)
         for pkg, url in runs.items()}
    got = ZarrLiteStore(os.path.join(d["torch"], "diags.zarr"))
    want = JStore(os.path.join(d["jax"], "diags.zarr"))
    for name in ("water_vapor_path", "time"):
        assert_close_scaled(got.read(name), want.read(name), RTOL, name=name)
    tsc = read_scalars(os.path.join(d["torch"], "scalars.jsonl"))
    jsc = read_scalars(os.path.join(d["jax"], "scalars.jsonl"))
    assert set(tsc) == set(jsc)
    for name in jsc:
        assert [r["time"] for r in tsc[name]] == \
            [r["time"] for r in jsc[name]]
        assert_close_scaled([r["value"] for r in tsc[name]],
                            [r["value"] for r in jsc[name]], RTOL, name=name)


def test_runfv3_cli_run_native_and_parse_logs(tmp_path, capsys):
    """run-native sets up and runs a segment on the named device;
    parse-logs turns the segment's scalars.jsonl into JSON."""
    cfg = {
        "namelist": dict(CONFIG["namelist"], segment_steps=1),
        "diagnostics": [],
    }
    cfg_path = tmp_path / "fv3config.yml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    rundir = str(tmp_path / "native")
    assert main(["run-native", str(cfg_path), rundir, "--device",
                 "cpu"]) == 0
    seg = os.path.join(rundir, "artifacts", "0000")
    assert os.path.isdir(os.path.join(seg, "RESTART"))
    scalars = os.path.join(seg, "scalars.jsonl")
    assert os.path.exists(scalars)
    capsys.readouterr()
    assert main(["parse-logs", scalars]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert any(len(v) >= 1 for v in doc.values())
    assert main(["append", rundir, "--n-steps", "1", "--device",
                 "cpu"]) == 0
    assert os.path.isdir(os.path.join(rundir, "artifacts", "0001",
                                      "RESTART"))


# Restart round trip in float32: write_restart stores T computed from pt
# and read_restart sets T, which converts back to pt through the same
# layer Exner function and (1 + zvir q): four roundings of float32, so T
# comes back to within 4 ulps (measured here: 0); the other seven fields
# are stored in float64 and come back bit for bit.
T_ULPS = 4


def test_restart_round_trip_float32(tmp_path):
    cfg = twrapper.ModelConfig(npx=7, npz=6, dt_atmos=600.0, n_split=4)
    twrapper.initialize(cfg, device="cpu")
    twrapper.set_state({"total_precipitation": twrapper.get_state(
        ["total_precipitation"])["total_precipitation"].with_data(
            np.full((6, 6, 6), 1e-3))})
    q = twrapper.get_state(["specific_humidity"])["specific_humidity"]
    twrapper.set_state({"specific_humidity": q.with_data(
        np.full(q.shape, 5e-3, np.float32))})
    twrapper.step_dynamics()
    twrapper.apply_physics()
    before = twrapper.get_state(trun.RESTART_NAMES + ["time"])
    path = str(tmp_path / "RESTART")
    trun.write_restart(twrapper, path)
    twrapper.initialize(cfg, device="cpu")
    trun.read_restart(twrapper, path)
    after = twrapper.get_state(trun.RESTART_NAMES + ["time"])
    assert after["time"] == before["time"]
    for name in trun.RESTART_NAMES:
        a, b = after[name].values, before[name].values
        if name == "air_temperature":
            assert a.dtype == np.float32
            ulps = np.abs(a - b) / np.spacing(np.abs(b))
            assert ulps.max() <= T_ULPS, (name, ulps.max())
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_config_diagnostics_and_logs_match_jax(tmp_path):
    """runtime/config (strict), runtime/diagnostics (time selection),
    utils/fv3logs and utils/artifacts against the JAX package's."""
    from fv3net_tpu.runtime import config as jconfig
    from fv3net_tpu.runtime import diagnostics as jdiag
    from fv3net_tpu.utils import fv3logs as jlogs
    from fv3net_tpu_torch.runtime import config as tconfig
    from fv3net_tpu_torch.runtime import diagnostics as tdiag
    from fv3net_tpu_torch.utils import artifacts, fv3logs

    cfg = dict(CONFIG, nudging={"timescale_hours": {"air_temperature": 3}},
               step_tendency_variables=["air_temperature"])
    got, want = tconfig.get_config(cfg), jconfig.get_config(cfg)
    assert repr(got).replace("fv3net_tpu_torch", "fv3net_tpu") == repr(want)
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError, match="unknown keys"):
            mod.get_config({"diagnostics": [{"nme": "x"}]})
    path = str(tmp_path / "c.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    assert tconfig.load_config_yaml(path) == cfg
    t0 = datetime.datetime(2016, 8, 1)
    times = [t0 + datetime.timedelta(seconds=450 * i) for i in range(9)]
    for kind in ({"kind": "every"},
                 {"kind": "interval", "frequency": 1800.0},
                 {"kind": "selected", "times": ["20160801.003000"]}):
        tc = tdiag.time_container(tconfig.TimeConfig(**kind))
        jc = jdiag.time_container(jconfig.TimeConfig(**kind))
        assert [t in tc for t in times] == [t in jc for t in times], kind
    text = "".join(
        fv3logs.dumps_statistics_block(t, {"total mass": 1.5 + i})
        for i, t in enumerate(times[:3]))
    got, want = fv3logs.loads(text), jlogs.loads(text)
    assert got.dates == want.dates and got.totals == want.totals
    meta = artifacts.StepMetadata(job_type="prognostic_run", url="u",
                                  commit="abc")
    meta.write(str(tmp_path / "meta.json"))
    with open(tmp_path / "meta.json") as f:
        assert json.load(f)["step_metadata"]["commit"] == "abc"
